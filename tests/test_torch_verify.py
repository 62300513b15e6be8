"""The port's conformance checker (``repro_torch.verify``) on the CPU.

1. Static parity: on every catalog cell x case x dtype x overlap mode, the
   port's ``trace_plan`` and ``check(measure=False)`` equal the reference's
   on the same planner-facing mesh stand-ins (records exactly; report
   numbers within relative 1e-12), as do the fat-tree and hex machine
   traces.
2. Measured: ``measure_plan`` runs each plan's per-rank programs on a
   single-controller CPU ``Mesh`` (ranks as threads); the executed multiset
   equals the trace on every catalog cell (square, fp32) and on the
   reference's ragged, batched and bf16 Cannon 2x2 cells, every rank calls
   the same sequence, and the communicator's copied bytes equal the trace's
   words times the element size each call carried (ppermute, all_gather;
   psum in both conventions).
3. Wrong programs -- a swapped movement permutation, Cannon without its B
   skew, one rank that skips or changes a collective -- are caught, and by
   the leg that must catch them.
4. Gloo worlds of 4 processes (Cannon 2x2, ring_rs on 4): each process
   captures its own rank.
5. Live: a planned ``Server(mesh=2x2).generate`` of the smoke Llama under
   ``intercept()`` executes exactly the summed traces of the plans it ran.

The full ``run_matrix`` (every cell, case and dtype, measured) is marked
``conformance``, as the reference marks its matrix.
"""
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as ref_plan
from repro.core.fattree import FatTreeSchedule as RefFatTree
from repro.core.hexarray import HexSchedule as RefHex
from repro.core.solver import solve_torus as ref_solve_torus
from repro.verify import conformance as ref_conf
from repro.verify import trace as ref_trace
from repro_torch import plan as port_plan
from repro_torch.configs import get_smoke_config
from repro_torch.core.fattree import FatTreeSchedule
from repro_torch.core.hexarray import HexSchedule
from repro_torch.core.solver import solve_torus
from repro_torch.dist import Mesh, _collectives
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve import ServeConfig
from repro_torch.serve import Server
from repro_torch.verify import (ConformanceError, check, check_capture, compare_records,
                                intercept, measure_plan, run_matrix, trace_plan)
from repro_torch.verify import conformance, trace as port_trace
from repro_torch.verify.conformance import _CATALOG, CASES, _overlap_modes
from repro_torch.verify.interceptor import phase_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
lower_dist_mod = importlib.import_module("repro_torch.plan.lower_dist")
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
REPORT_RTOL = 1e-12
WORLD_TIMEOUT_S = 240


def fake_mesh(sizes, names):
    """Planner-facing mesh stand-in (no devices behind it), for both packages."""
    total = math.prod(sizes)
    return SimpleNamespace(
        axis_names=tuple(names), shape=dict(zip(names, sizes)), size=total,
        devices=np.array([SimpleNamespace(id=i, platform="cpu") for i in range(total)]))


@pytest.fixture(autouse=True)
def _clear_caches():
    port_plan.cache_clear()
    lower_dist_mod._lower_dist_cached.cache_clear()
    yield
    lower_dist_mod._lower_dist_cached.cache_clear()


@pytest.fixture(scope="module")
def meshes():
    """Single-controller CPU meshes, one per catalog shape, closed at the end."""
    made = {}

    def get(shape, names):
        if (shape, names) not in made:
            made[shape, names] = Mesh(shape, names, device="cpu")
        return made[shape, names]

    yield get
    for mesh in made.values():
        mesh.close()


def _cells():
    out = []
    for strategy, shape, names in _CATALOG:
        for case in CASES:
            for dtype in DTYPES:
                for mode in _overlap_modes(strategy, shape):
                    out.append(pytest.param(strategy, shape, names, case, dtype, mode,
                                            id=f"{strategy}-{'x'.join(map(str, shape))}-"
                                               f"{case}-{dtype}-ov{mode}"))
    return out


def _plans(strategy, shape, names, case, dtype, mode):
    spec = CASES[case]
    mesh = fake_mesh(shape, names)
    kw = dict(mesh=mesh, strategy=strategy, batch=spec["batch"], overlap=mode)
    tdt, jdt = DTYPES[dtype]
    return (port_plan.build_plan(spec["m"], spec["n"], spec["k"], a_dtype=tdt, b_dtype=tdt,
                                 **kw),
            ref_plan.build_plan(spec["m"], spec["n"], spec["k"], a_dtype=jdt, b_dtype=jdt,
                                **kw))


def _records(trace):
    return [(r.key, r.phase, r.var) for r in trace.records]


def _close(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return math.isclose(a, b, rel_tol=REPORT_RTOL, abs_tol=0.0)


# -- 1. static parity -----------------------------------------------------------------


@pytest.mark.parametrize("strategy,shape,names,case,dtype,mode", _cells())
def test_trace_and_static_check_match_reference(strategy, shape, names, case, dtype, mode):
    port, ref = _plans(strategy, shape, names, case, dtype, mode)
    assert port.overlap == ref.overlap
    pt, rt = trace_plan(port), ref_trace.trace_plan(ref)
    assert _records(pt) == _records(rt) and pt.records
    assert (pt.strategy, pt.mesh_size, pt.grid, pt.padded, pt.peak_node_words, pt.counts()) == \
        (rt.strategy, rt.mesh_size, rt.grid, rt.padded, rt.peak_node_words, rt.counts())
    assert port_trace.padded_dims(port) == ref_trace.padded_dims(ref)
    assert (conformance.memory_bound_words(port) == ref_conf.memory_bound_words(ref))
    assert _close(conformance.predicted_words_per_device(port),
                  ref_conf.predicted_words_per_device(ref))
    prep, rrep = check(port), ref_conf.check(ref)
    for field in dataclasses.fields(prep):
        if field.name == "hlo_collective_bytes":
            continue
        a, b = getattr(prep, field.name), getattr(rrep, field.name)
        if isinstance(a, float) or isinstance(b, float):
            assert _close(a, b), field.name
        else:
            assert a == b, field.name


@pytest.mark.parametrize("d", [1, 2])
def test_fattree_machine_trace_matches_reference(d):
    pt, rt = port_trace.trace_fattree(FatTreeSchedule(d)), ref_trace.trace_fattree(RefFatTree(d))
    assert (pt.model, pt.num_nodes, pt.num_steps, pt.events) == \
        (rt.model, rt.num_nodes, rt.num_steps, rt.events)
    assert port_trace.fattree_level_words(pt, d) == ref_trace.fattree_level_words(rt, d)
    assert port_trace.fattree_a_level_words(pt, d) == ref_trace.fattree_a_level_words(rt, d)
    assert port_trace.fattree_level_words(pt, d) == FatTreeSchedule(d).link_traffic()


@pytest.mark.parametrize("q", [2, 3])
def test_hex_machine_trace_matches_reference(q):
    pt, rt = port_trace.trace_hex(HexSchedule(q)), ref_trace.trace_hex(RefHex(q))
    assert (pt.model, pt.num_nodes, pt.num_steps, pt.events) == \
        (rt.model, rt.num_nodes, rt.num_steps, rt.events)
    assert pt.words_total() == 3 * q * q * (q - 1)


@pytest.mark.parametrize("q", [2, 3, 4])
def test_single_copy_invariant_matches_reference(q):
    """The per-step single-copy memory invariant on the solver's first
    solutions."""
    port = [s.schedule for s in solve_torus(q, max_solutions=12)]
    ref = [s.schedule for s in ref_solve_torus(q, max_solutions=12)]
    assert ([port_trace.torus_single_copy_ok(s) for s in port]
            == [ref_trace.torus_single_copy_ok(s) for s in ref])
    assert all(port_trace.torus_single_copy_ok(s) for s in port)


def test_hlo_leg_waits_for_the_roofline_tooling():
    """The HLO leg that waited for the roofline tooling now runs on it: the
    plan's per-rank programs counted on fake tensors, one rank's collective
    bytes present where the trace has words (the reference's rule)."""
    from repro_torch.dist.mesh import Mesh

    mesh = Mesh((2, 2), ("x", "y"), device="cpu")
    try:
        plan = port_plan.build_plan(24, 24, 24, mesh=mesh, strategy="cannon")
        got = conformance.hlo_collective_bytes(plan)
        rep = check(plan, hlo=True)
    finally:
        mesh.close()
    # cannon on 2x2: the skew and one step move A's and B's 12x12 fp32 blocks
    assert got == 4 * (2 * 12 * 12) * 2 and rep.hlo_collective_bytes == got


# -- 2. measured on CPU thread meshes -----------------------------------------------------


def _square_cells():
    return [pytest.param(strategy, shape, names, mode,
                         id=f"{strategy}-{'x'.join(map(str, shape))}-ov{mode}")
            for strategy, shape, names in _CATALOG
            for mode in _overlap_modes(strategy, shape)]


def _psum_bytes_thread_convention(cap, mesh_size):
    """Bytes the thread communicator copies for the captured psums: g - 1
    shards into each of the mesh's ranks."""
    return sum((r.group - 1) * r.shard_words * mesh_size * size
               for r, size in zip(cap.records, cap.itemsizes) if r.kind == "psum")


@pytest.mark.parametrize("strategy,shape,names,mode", _square_cells())
def test_measured_matches_trace_on_thread_mesh(meshes, strategy, shape, names, mode):
    spec = CASES["square"]
    mesh = meshes(shape, names)
    plan = port_plan.build_plan(spec["m"], spec["n"], spec["k"], mesh=mesh, strategy=strategy,
                                overlap=mode)
    rep = check(plan, measure=True)
    assert rep.measured
    tr = trace_plan(plan)
    _collectives.reset_stats()
    cap = measure_plan(plan)
    compare_records(tr.records, cap.records)
    assert cap.ranks == tuple(range(mesh.size)) and cap.divergence() is None
    assert any(p is plan for p in cap.lowered_plans)
    # bytes: trace words x the element size each call carried
    by_phase = phase_bytes(tr, cap)
    for kind in ("ppermute", "all_gather"):
        want = sum(v for (k, _), v in by_phase.items() if k == kind)
        assert _collectives.stats[kind]["bytes"] == want, (kind, by_phase)
    assert _collectives.stats["psum"]["bytes"] == _psum_bytes_thread_convention(cap, mesh.size)


DEFERRED_CELLS = [("cannon", (2, 2), ("x", "y")), ("summa", (2, 2), ("x", "y")),
                  ("ring_ag", (2, 2), ("x", "y")), ("ring_ag", (4,), ("t",)),
                  ("cannon25d", (2, 2, 2), ("pod", "x", "y")),
                  ("pod25d", (2, 2, 2), ("pod", "x", "y"))]


@pytest.mark.parametrize("strategy,shape,names", DEFERRED_CELLS,
                         ids=[f"{s}-{'x'.join(map(str, z))}" for s, z, _ in DEFERRED_CELLS])
def test_deferred_permutes_count_once_as_the_references_trace(meshes, strategy, shape, names):
    """An overlapped body's deferred ppermutes under the interceptor, obs,
    the cost counter and ``_collectives.stats`` at once: the interceptor's
    and obs's multisets equal the reference's trace of the same plan, and
    the counter and stats count each ppermute once on every rank."""
    from collections import Counter

    from repro_torch import obs
    from repro_torch.roofline import hlo_stats

    spec = CASES["square"]
    mode = None if strategy == "ring_ag" else True
    _, ref = _plans(strategy, shape, names, "square", "float32", mode)
    want = Counter(r.key for r in ref_trace.trace_plan(ref).records)
    mesh = meshes(shape, names)
    plan = port_plan.build_plan(spec["m"], spec["n"], spec["k"], mesh=mesh, strategy=strategy,
                                batch=spec["batch"], overlap=mode)
    flat_m = plan.m * math.prod(plan.batch)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((flat_m, plan.k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((plan.k, plan.n), dtype=np.float32))
    dones = []
    done = _collectives.ppermute_done
    _collectives.reset_stats()
    with mock.patch.object(_collectives, "ppermute_done", lambda h: dones.append(1) or done(h)), \
            intercept() as cap, obs.observe() as rec, hlo_stats.counting() as counter:
        port_plan.execute_plan(plan, a, b)
    assert dones and cap.divergence() is None
    assert Counter(r.key for r in cap.records) == want
    assert obs.collective_multiset(rec) == want
    permutes = sum(n for key, n in want.items() if key[0] == "ppermute")
    assert _collectives.stats["ppermute"]["calls"] == permutes * mesh.size
    assert counter.calls["COLL:collective-permute"] == permutes * mesh.size


@pytest.mark.parametrize("kwargs", [
    dict(m=13, n=7, k=11), dict(m=5, n=8, k=12, batch=(3,)),
    dict(m=16, n=16, k=16, a_dtype=torch.bfloat16, b_dtype=torch.bfloat16)],
    ids=["ragged", "batched", "bf16"])
def test_measured_cannon_2x2_ragged_batched_bf16(meshes, kwargs):
    kwargs = dict(kwargs)
    m, n, k = kwargs.pop("m"), kwargs.pop("n"), kwargs.pop("k")
    plan = port_plan.build_plan(m, n, k, mesh=meshes((2, 2), ("x", "y")), strategy="cannon",
                                **kwargs)
    check(plan, measure=True)
    cap = measure_plan(plan)
    itemsize = torch.empty((), dtype=plan.out_dtype).element_size()
    # A and B blocks move at the operand width, the stationary C not at all
    assert set(cap.itemsizes) == {itemsize}


def test_ring_rs_partials_move_at_fp32(meshes):
    """The fp32 partial sums of ring_rs: bf16 operands, 4-byte calls, so
    the copied bytes are the cost words at 4 bytes, not the estimate's 2."""
    plan = port_plan.build_plan(32, 32, 32, mesh=meshes((4,), ("t",)), strategy="ring_rs",
                                a_dtype=torch.bfloat16, b_dtype=torch.bfloat16)
    _collectives.reset_stats()
    cap = measure_plan(plan)
    assert set(cap.itemsizes) == {4}
    per_rank = _collectives.stats["ppermute"]["bytes"] / 4
    assert per_rank == 4 * plan.cost.comm_bytes / 2


# -- 3. wrong programs ----------------------------------------------------------------------


def _swapped_step_a(plan):
    pairs = list(plan.torus.step_a)
    pairs[0], pairs[1] = (pairs[0][0], pairs[1][1]), (pairs[1][0], pairs[0][1])
    return dataclasses.replace(plan, torus=dataclasses.replace(plan.torus, step_a=tuple(pairs)))


@pytest.mark.parametrize("shape", [(2, 2), (3, 3)])
def test_wrong_permutation_caught_statically_and_at_interceptor(meshes, shape):
    plan = port_plan.build_plan(24, 24, 24, mesh=meshes(shape, ("x", "y")), strategy="cannon")
    bad = _swapped_step_a(plan)
    with pytest.raises(ConformanceError, match=r"^\[structure\]"):
        check(bad)
    cap = measure_plan(bad)
    with pytest.raises(ConformanceError, match=r"^\[interceptor\]"):
        compare_records(trace_plan(plan).records, cap.records)


def _drop_b_skew(body_fn):
    return lambda prog, *a, **kw: body_fn(dataclasses.replace(prog, skew_b=()), *a, **kw)


@pytest.mark.parametrize("overlap", [False, True])
def test_cannon_without_b_skew_caught_at_interceptor(meshes, monkeypatch, overlap):
    plan = port_plan.build_plan(24, 24, 24, mesh=meshes((2, 2), ("x", "y")), strategy="cannon",
                                overlap=overlap)
    check(plan)  # the plan is sound; only its execution is wrong
    name = "torus_program_body_overlapped" if overlap else "torus_program_body"
    monkeypatch.setattr(lower_dist_mod, name, _drop_b_skew(getattr(lower_dist_mod, name)))
    with pytest.raises(ConformanceError, match=r"^\[interceptor\] executed collectives"):
        check(plan, measure=True)


def _one_rank_differs(body_fn, how):
    """``body_fn`` whose rank 3 skips its B skew (``skip``) or shifts A the
    other way round (``change``); every other rank runs the plan."""

    def make(prog, *a, **kw):
        good = body_fn(prog, *a, **kw)
        if how == "skip":
            odd = body_fn(dataclasses.replace(prog, skew_b=()), *a, **kw)
        else:
            odd = body_fn(dataclasses.replace(
                prog, step_a=tuple((d, s) for s, d in prog.step_a)), *a, **kw)
        return lambda ab, bb: (odd if _collectives.rank() == 3 else good)(ab, bb)

    return make


@pytest.mark.parametrize("how", ["skip", "change"])
def test_a_rank_that_diverges_fails_only_the_interceptor_leg(meshes, monkeypatch, how):
    """One rank's program differs: the plan passes every static leg, and
    ``measure_plan`` names the ranks, whether the difference made the run
    fail (a skipped collective: chained from the run's error) or not."""
    plan = port_plan.build_plan(24, 24, 24, mesh=meshes((3, 3), ("x", "y")),
                                strategy="cannon", overlap=False)
    check(plan)
    monkeypatch.setattr(lower_dist_mod, "torus_program_body",
                        _one_rank_differs(lower_dist_mod.torus_program_body, how))
    with pytest.raises(ConformanceError,
                       match=r"^\[interceptor\] the ranks ran different programs: rank 3"
                       ) as info:
        check(plan, measure=True)
    if how == "skip":
        assert isinstance(info.value.__cause__, _collectives.RankAborted)
    else:
        assert info.value.__cause__ is None


def test_measure_plan_needs_a_mesh():
    plan = port_plan.build_plan(8, 8, 8, mesh=fake_mesh((2, 2), ("x", "y")), strategy="summa")
    with pytest.raises(ValueError, match="repro_torch Mesh"):
        measure_plan(plan)


def test_run_matrix_reports_every_cell_instead_of_raising(monkeypatch):
    """The card is the default: without one, every row is a failure with
    its reason, and nothing raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = run_matrix(cases=("square",), dtypes=(torch.float32,), num_devices=4)
    assert rows and all(not r["ok"] and "CUDA is not available" in r["error"] for r in rows)
    assert {r["strategy"] for r in rows} == {"cannon", "summa", "pod25d", "cannon25d",
                                             "ring_ag", "ring_rs"}


# -- 4. gloo worlds ----------------------------------------------------------------------------

_WORKER = r"""
import json, sys
from datetime import timedelta
import torch.distributed as dist
from repro_torch.dist import Mesh
from repro_torch.plan import build_plan
from repro_torch.verify import check, compare_records, measure_plan, trace_plan

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cases = eval(sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank,
                        world_size=world, timeout=timedelta(seconds=120))
out = []
for sizes, names, strategy, overlap, (m, n, k) in cases:
    mesh = Mesh(sizes, names, device="cpu", rank=rank)
    plan = build_plan(m, n, k, mesh=mesh, strategy=strategy, overlap=overlap)
    check(plan, measure=True)
    cap = measure_plan(plan)
    compare_records(trace_plan(plan).records, cap.records)
    out.append({"ranks": list(cap.ranks), "records": len(cap.records),
                "trace": len(trace_plan(plan).records)})
json.dump(out, open(f"{tmp}/out{rank}.json", "w"))
dist.destroy_process_group()
print("RANK_OK", rank)
"""

GLOO_CASES = [((2, 2), ("x", "y"), "cannon", False, (24, 24, 24)),
              ((2, 2), ("x", "y"), "cannon", True, (13, 7, 11)),
              ((4,), ("t",), "ring_rs", None, (24, 24, 24)),
              ((4,), ("t",), "ring_rs", None, (13, 7, 11))]


@pytest.mark.timeout(WORLD_TIMEOUT_S + 60)
def test_gloo_world_of_4_conforms(tmp_path):
    world = 4
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world),
                               str(tmp_path), repr(GLOO_CASES)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f"world of {world} ranks did not finish in {WORLD_TIMEOUT_S}s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(logs):
        assert rc == 0 and f"RANK_OK {r}" in out, f"rank {r}: rc {rc}\n{err[-3000:]}"
        got = json.load(open(tmp_path / f"out{r}.json"))
        assert [g["ranks"] for g in got] == [[r]] * len(GLOO_CASES)
        assert all(g["records"] == g["trace"] > 0 for g in got), got


# -- 5. live serving ----------------------------------------------------------------------------


def test_planned_generate_executes_the_summed_traces():
    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    server = Server(model, params, ServeConfig(max_new_tokens=4, max_seq=32), mesh=(2, 2),
                    buckets=[(4, 8)])
    server.warmup()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in (3, 5, 8, 2)]
    with intercept() as cap:
        res = server.generate(prompts)
    server.mesh.close()
    assert [len(t) for t in res.new_tokens] == [4] * 4
    products = 7 * cfg.num_layers * 4           # 1 prefill + 3 decode steps
    assert len(cap.lowered_plans) == products
    assert sum(server.plan_report()["strategies"].values()) == products
    counts = check_capture(cap)
    assert cap.ranks == (0, 1, 2, 3) and sum(counts.values()) == len(cap.records) > 0
    # one product fewer in the summed traces is caught
    cap.lowered_plans.pop()
    with pytest.raises(ConformanceError, match=r"^\[interceptor\]"):
        check_capture(cap)


# -- the full matrix ------------------------------------------------------------------------------


@pytest.mark.conformance
@pytest.mark.timeout(1800)
def test_run_matrix_full_on_cpu():
    """Every catalog cell x case x dtype x overlap mode, measured on CPU
    thread meshes of up to 16 ranks."""
    rows = run_matrix(device="cpu")
    bad = [r for r in rows if not r["ok"]]
    assert not bad, f"{len(bad)}/{len(rows)} non-conforming cells: {bad[:5]}"
    assert len(rows) == len(_cells())
