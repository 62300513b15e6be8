"""The port's K1 autotuning (``repro_torch.tune``) against ``repro.tune``, on the CPU.

* Tables: the JSON schema is the reference's, so a table saved by either
  package loads in the other, with ``scaled_call_seconds`` equal to the
  reference's (shapes whose dims are multiples of 128, where the
  reference's MXU padding and the port's unpadded FLOPs agree).  The
  port's buckets keep K1's route thresholds apart.
* The search: ``candidate_space`` is exactly what ``ops.matmul`` accepts;
  a candidate displaces K1's default blocks only when it beats them by
  more than the timing noise; the tuner searches once per bucket and, on
  the CPU, only with an injected timer (there is no kernel to time).
* The planner: with the same table entries at every strategy's local
  bucket, ``build_plan(tuning=...)`` and ``rank_mesh_strategies`` agree
  with ``repro.plan`` on fake meshes -- strategy, overlap, tuned tiling,
  and ranking seconds within relative 1e-9.
"""
import dataclasses
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as ref_plan
from repro.obs.profile import LinkParams as RefLink
from repro.obs.profile import MachineProfile as RefProfile
from repro.tune import table as ref_table
from repro_torch import plan as port_plan
from repro_torch.dist.mesh import Mesh
from repro_torch.kernels.matmul import kernel, matmul
from repro_torch.obs.profile import LinkParams, MachineProfile
from repro_torch.tune import (TunedBlocks, TuningTable, Tuner, candidate_route,
                              candidate_space, default_candidate, load_table, save_table,
                              scaled_call_seconds, shape_bucket, tune_shape, tune_shapes)
from repro_torch.tune.search import NOISE

port_ir = __import__("repro_torch.plan.ir", fromlist=["ir"])
ref_ir = __import__("repro.plan.ir", fromlist=["ir"])
SECONDS_RTOL = 1e-9


def fake_mesh(sizes, names):
    total = math.prod(sizes)
    return SimpleNamespace(
        axis_names=tuple(names), shape=dict(zip(names, sizes)), size=total,
        devices=np.array([SimpleNamespace(id=i, platform="cpu") for i in range(total)]))


@pytest.fixture(autouse=True)
def _clear_plan_caches():
    port_plan.cache_clear()
    ref_plan.cache_clear()
    yield


def _fake_timer(m, n, k, dtype, cand):
    """Deterministic seconds that prefer rowmajor and the 64-row tiles."""
    bm, bn, bk, order = cand
    return 1e-6 * (1 + (bm != 64) + 0.5 * (order == "zorder")) * m * n * k / 2 ** 20


# -- buckets, tables ------------------------------------------------------------------


@pytest.mark.parametrize("m, rows", [(1, 16), (4, 16), (16, 16), (17, 64), (64, 64),
                                     (65, 128), (128, 128), (129, 256), (4096, 4096)])
def test_bucket_rows_keep_k1s_routes_apart(m, rows):
    assert shape_bucket(m, 512, 2048)[0] == rows
    # every row count of a bucket takes the bucket's route
    assert kernel.route(m, 512, 2048, torch.bfloat16) == \
        kernel.route(rows, 512, 2048, torch.bfloat16)


@pytest.mark.parametrize("n, k, want", [(512, 2048, (512, 2048)), (960, 3840, (1024, 4096)),
                                        (300, 70, (300, 70)), (8, 16, (8, 16)),
                                        (24, 7, (32, 7))])
def test_bucket_columns_round_aligned_dims_and_keep_others(n, k, want):
    """Multiples of 8 round up to powers of two; other dims stay exact, so
    the bucket's timing shape takes the route (thin/wide or wmma) the call
    takes."""
    assert shape_bucket(4, n, k)[1:] == want
    bucket = shape_bucket(4, n, k)
    assert kernel.route(4, n, k, torch.bfloat16) == kernel.route(*bucket, torch.bfloat16)


def _tables():
    """The same entries in a port and a reference table (buckets that are
    the same in both packages)."""
    rng = np.random.default_rng(0)
    port = TuningTable(device_kind="NVIDIA H100 80GB HBM3", created="c")
    ref = ref_table.TuningTable(device_kind="NVIDIA H100 80GB HBM3", created="c")
    for (m, n, k), dtype in [((256, 256, 256), "float32"), ((512, 1024, 2048), "bfloat16"),
                             ((4096, 128, 256), "bfloat16")]:
        assert shape_bucket(m, n, k) == ref_table.shape_bucket(m, n, k)
        s, order = float(rng.uniform(1e-6, 1e-3)), ["zorder", "rowmajor"][m % 3 == 0]
        port = port.with_entry(m, n, k, dtype, TunedBlocks(128, 128, 64, order, s, (m, n, k)))
        ref = ref.with_entry(m, n, k, dtype, ref_table.TunedBlocks(128, 128, 64, order, s,
                                                                   (m, n, k)))
    return port, ref


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_table_saved_by_either_package_loads_in_the_other(tmp_path, writer):
    port, ref = _tables()
    path = str(tmp_path / "t.json")
    if writer == "port":
        save_table(port, path)
        back = ref_table.load_table(path)
        assert back == ref
    else:
        ref_table.save_table(ref, path)
        back = load_table(path)
        assert back == port
    for key, entry in port.entries:
        ref_entry = dict(ref.entries)[key]
        for shape in [(key[1], key[2], key[3]), (key[1] // 2, key[2], key[3]),
                      (128, 128, 128)]:
            assert scaled_call_seconds(entry, *shape) == pytest.approx(
                ref_table.scaled_call_seconds(ref_entry, *shape), rel=1e-12)


def test_table_stats_newer_schema_and_hash():
    port, _ = _tables()
    h0 = hash(port)
    assert port.lookup(512, 1024, 2048, "bfloat16") is not None
    assert port.lookup(4, 4, 4, "bfloat16") is None
    assert port.stats == {"hits": 1, "misses": 1} and hash(port) == h0
    obj = port.to_json()
    obj["schema"] = 99
    with pytest.raises(ValueError, match="newer than supported"):
        TuningTable.from_json(obj)


# -- the search -----------------------------------------------------------------------


def _accepted(m, n, k, dtype):
    """Every (blocks, order) ``ops.matmul`` runs at this shape (on CPU
    tensors, which check the blocks and take the plain version)."""
    a = torch.zeros(m, k, dtype=dtype)
    b = torch.zeros(k, n, dtype=dtype)
    out = set()
    for dt in (torch.float32, torch.bfloat16):
        for blocks in kernel.BLOCKS[dt]:
            for order in ("zorder", "rowmajor"):
                try:
                    matmul(a, b, block_m=blocks[0], block_n=blocks[1], block_k=blocks[2],
                           order=order)
                except ValueError:
                    continue
                out.add(blocks + (order,))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 512, 2048), (64, 8192, 2048), (300, 300, 70),
                                   (17, 7, 16), (256, 960, 3840), (1, 8, 0)])
def test_candidate_space_is_what_matmul_accepts(shape, dtype):
    m, n, k = shape
    cands = candidate_space(m, n, k, dtype)
    assert set(cands) == _accepted(m, n, k, dtype)
    assert len(cands) == len(set(cands))
    for c in cands:
        assert candidate_route(c, dtype) == kernel.ROUTE_OF[dtype, c[:3]]


def test_max_candidates_bounds_deterministically():
    full = candidate_space(64, 512, 2048)
    sub = candidate_space(64, 512, 2048, max_candidates=5)
    assert len(sub) == 5 and set(sub) <= set(full)
    assert sub == candidate_space(64, 512, 2048, max_candidates=5)


def test_tune_shape_with_a_timer_picks_the_fastest():
    trials = []
    e = tune_shape(4, 512, 2048, "bfloat16", timer=_fake_timer, trials=trials)
    assert e.bucket == (16, 512, 2048)
    assert (e.block_m, e.order) == (64, "rowmajor")
    assert len(trials) == len(candidate_space(16, 512, 2048))
    assert {t["route"] for t in trials} == {"wide", "thin", "wmma"}
    assert e.seconds == min(t["seconds"] for t in trials)


def test_the_tuner_searches_once_per_bucket_and_raises_on_the_cpu_without_a_timer():
    tuner = Tuner(device="cpu", timer=_fake_timer)
    e1 = tuner.entry_for(4, 512, 2048)
    e2 = tuner.entry_for(16, 500, 2000)   # 500 and 2000 are multiples of 4, not 8
    e3 = tuner.entry_for(9, 512, 2048)    # the same bucket as the first
    assert e1 is e3 and e2 is not e1
    assert tuner.stats == {"hits": 1, "misses": 2, "searches": 2}
    assert tuner.compute_seconds(4, 512, 2048) == pytest.approx(
        e1.seconds * (4 * 512 * 2048) / (16 * 512 * 2048))
    table = tuner.table()
    assert table.device_kind == "cpu" and len(table.entries) == 2
    with pytest.raises(RuntimeError, match="no kernel to time"):
        Tuner(device="cpu").entry_for(4, 512, 2048)
    assert tune_shapes([(4, 512, 2048)], timer=_fake_timer, device="cpu").entries[0][1] == e1


# -- the planner -----------------------------------------------------------------------

# (mesh sizes, (m, n, k)): every strategy's local kernel shape has dims that
# are powers of two >= 128, where both packages bucket alike
PLANNER_CASES = [((4, 4), (4096, 4096, 4096)), ((2, 2), (4096, 4096, 4096)),
                 ((2, 4), (1024, 2048, 8192)), ((2, 2, 2), (4096, 4096, 4096)),
                 ((2,), (256, 256, 65536))]
NAMES = {1: ("t",), 2: ("x", "y"), 3: ("pod", "x", "y")}


def _planner_tables(mesh, m, n, k, seed):
    """Port and reference tables with the same seconds at every candidate
    strategy's local bucket."""
    rng = np.random.default_rng(seed)
    port = TuningTable(device_kind="cpu")
    ref = ref_table.TuningTable(device_kind="cpu")
    for strategy in port_plan.mesh_candidates(mesh):
        ax = port_ir._plan_axes(mesh, strategy, None)
        grid = port_ir._grid_for(mesh, strategy, ax)
        local = port_ir._local_kernel_shape(strategy, grid, m, n, k, mesh.size)
        assert local == ref_ir._local_kernel_shape(strategy, grid, m, n, k, mesh.size)
        bucket = shape_bucket(*local)
        assert bucket == ref_table.shape_bucket(*local)
        s = float(rng.uniform(1e-5, 1e-1))
        order = ["zorder", "rowmajor"][int(rng.integers(2))]
        port = port.with_entry(*local, "bfloat16", TunedBlocks(64, 64, 64, order, s, bucket))
        ref = ref.with_entry(*local, "bfloat16",
                             ref_table.TunedBlocks(64, 64, 64, order, s, bucket))
    return port, ref


def _profiles():
    links = (("ici", (2e-5, 4e11)),)
    return (MachineProfile("cpu", 5e14, tuple((n, LinkParams(*p)) for n, p in links)),
            RefProfile("cpu", 5e14, tuple((n, RefLink(*p)) for n, p in links)))


@pytest.mark.parametrize("with_profile", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", PLANNER_CASES, ids=[f"{'x'.join(map(str, c[0]))}"
                                                     for c in PLANNER_CASES])
def test_tuned_planning_equals_the_reference(case, seed, with_profile):
    sizes, (m, n, k) = case
    mesh = fake_mesh(sizes, NAMES[len(sizes)])
    port_tbl, ref_tbl = _planner_tables(mesh, m, n, k, seed)
    port_prof, ref_prof = _profiles() if with_profile else (None, None)
    port_rank = port_plan.rank_mesh_strategies(m, n, k, mesh, 2, profile=port_prof,
                                               tuning=port_tbl, dtype="bfloat16")
    ref_rank = ref_plan.rank_mesh_strategies(m, n, k, mesh, 2, profile=ref_prof,
                                             tuning=ref_tbl, dtype="bfloat16")
    assert [e.strategy for e in port_rank] == [e.strategy for e in ref_rank]
    for pe, re in zip(port_rank, ref_rank):
        got = port_plan.strategy_seconds(pe, mesh, profile=port_prof, tuning=port_tbl,
                                         dtype="bfloat16")
        want = ref_plan.strategy_seconds(re, mesh, profile=ref_prof, tuning=ref_tbl,
                                         dtype="bfloat16")
        assert got == pytest.approx(want, rel=SECONDS_RTOL)
    p = port_plan.build_plan(m, n, k, mesh=mesh, a_dtype=torch.bfloat16,
                             b_dtype=torch.bfloat16, tuning=port_tbl, profile=port_prof,
                             use_cache=False)
    r = ref_plan.build_plan(m, n, k, mesh=mesh, a_dtype=jnp.bfloat16, b_dtype=jnp.bfloat16,
                            tuning=ref_tbl, profile=ref_prof, use_cache=False)
    assert (p.strategy, p.overlap, p.grid) == (r.strategy, r.overlap, r.grid)
    assert dataclasses.asdict(p.tiling) == {
        key: v for key, v in dataclasses.asdict(r.tiling).items() if key != "interpret"}
    assert p.tiling.tuned and p.tiling.block_m == 64


def test_a_doctored_table_flips_strategy_and_overlap():
    """tests/test_tune.py's pins on the port: a slow cannon bucket and a free
    summa bucket flip a 4x4 mesh to summa; zero compute turns overlap off."""
    mesh = fake_mesh((4, 4), ("x", "y"))
    m = n = k = 4096
    assert port_plan.rank_mesh_strategies(m, n, k, mesh)[0].strategy == "cannon"
    tbl = TuningTable(device_kind="cpu").with_entry(
        1024, 1024, 1024, "float32", TunedBlocks(64, 64, 16, "zorder", 10.0, (1024,) * 3))
    tbl = tbl.with_entry(1024, 1024, 256, "float32",
                         TunedBlocks(64, 64, 16, "zorder", 1e-9, (1024, 1024, 256)))
    plan = port_plan.build_plan(m, n, k, mesh=mesh, tuning=tbl, use_cache=False)
    assert plan.strategy == "summa" and plan.tiling.tuned
    mesh22 = fake_mesh((2, 2), ("x", "y"))
    kw = dict(mesh=mesh22, strategy="cannon", use_cache=False)
    assert port_plan.build_plan(m, n, k, **kw).overlap is True
    zero = TuningTable(device_kind="cpu").with_entry(
        2048, 2048, 2048, "float32", TunedBlocks(64, 64, 16, "zorder", 0.0, (2048,) * 3))
    assert port_plan.build_plan(m, n, k, tuning=zero, **kw).overlap is False


def test_tuning_is_in_the_plan_cache_key_and_explicit_tiling_wins():
    tbl = TuningTable(device_kind="cpu").with_entry(
        256, 256, 256, "float32", TunedBlocks(16, 64, 32, "rowmajor", 1e-4, (256,) * 3))
    p0 = port_plan.build_plan(256, 256, 256)
    p1 = port_plan.build_plan(256, 256, 256, tuning=tbl)
    assert not p0.tiling.tuned and p1.tiling.tuned
    assert (p1.tiling.block_m, p1.tiling.order) == (16, "rowmajor")
    assert port_plan.build_plan(256, 256, 256) is p0
    assert port_plan.build_plan(256, 256, 256, tuning=tbl) is p1
    explicit = port_plan.build_plan(256, 256, 256, tuning=tbl, use_cache=False,
                                    tiling=port_plan.TilingPlan(block_m=64, block_n=64,
                                                                block_k=16))
    assert not explicit.tiling.tuned and explicit.tiling.block_m == 64


@pytest.mark.parametrize("strategy", ["cannon", "summa", "ring_ag", "ring_rs"])
def test_tuned_plans_execute_on_a_cpu_thread_mesh(strategy):
    """A live tuner (injected timer) tunes each plan's local bucket at plan
    time; the tuned product equals the untuned one (the plain version on
    the CPU is exact whatever the blocks)."""
    mesh = Mesh((2, 2), device="cpu")
    tuner = Tuner(device="cpu", timer=_fake_timer)
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 128), dtype=np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((128, 256), dtype=np.float32)).to(torch.bfloat16)
    plan = port_plan.build_plan(64, 256, 128, mesh=mesh, strategy=strategy, tuning=tuner,
                                a_dtype=torch.bfloat16, b_dtype=torch.bfloat16)
    assert plan.tiling.tuned and tuner.stats["searches"] == 1
    untuned = port_plan.build_plan(64, 256, 128, mesh=mesh, strategy=strategy,
                                   a_dtype=torch.bfloat16, b_dtype=torch.bfloat16)
    assert torch.equal(port_plan.execute_plan(plan, a, b),
                       port_plan.execute_plan(untuned, a, b))
    mesh.close()


def test_tuned_blocks_run_on_a_misaligned_view(monkeypatch):
    """A bucket says nothing of a view's base address: thin blocks on a
    misaligned view run on an aligned copy of it, with the plan's blocks."""
    import importlib

    lower_local = importlib.import_module("repro_torch.plan.lower_local")
    tiling = port_plan.TilingPlan(order="rowmajor", block_m=16, block_n=64, block_k=64,
                                  tuned=True)
    fn = port_plan.lower_tiling(tiling)
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.standard_normal(4 * 64 + 1, dtype=np.float32)).to(
        torch.bfloat16)
    a = base[1:].view(4, 64)                   # 2-byte offset: not 16-byte aligned
    b = torch.from_numpy(rng.standard_normal((64, 64), dtype=np.float32)).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        matmul(a, b, block_m=16, block_n=64, block_k=64)
    calls = []

    def recording(x, y, **kw):
        calls.append((x.data_ptr() % 16, y.data_ptr() % 16, kw))
        return matmul(x, y, **kw)

    monkeypatch.setattr(lower_local, "matmul", recording)
    out = fn(a, b)
    assert calls == [(0, 0, dict(block_m=16, block_n=64, block_k=64, order="rowmajor",
                                 out_dtype=torch.bfloat16))]
    assert torch.equal(out, matmul(a.clone(), b))


def _margin_timer(default_s, challenger_s):
    """Seconds for the default candidate and one challenger, each a
    sequence (one per timing); every other candidate is slower than both."""
    seen = []

    def timer(m, n, k, dtype, cand):
        seen.append(cand)
        if cand == default_candidate(m, n, k, dtype):
            return default_s[seen.count(cand) - 1]
        if cand == (64, 64, 64, "rowmajor"):
            return challenger_s[seen.count(cand) - 1]
        return 1.0
    return timer


FAST = 1e-5 * (1 - 2 * NOISE)


@pytest.mark.parametrize("default_s, challenger_s, wins", [
    ((1e-5, 1e-5), (1e-5 * (1 - NOISE / 2),) * 2, False),   # inside the noise floor
    ((1e-5, 1e-5), (FAST, FAST), True),                  # beyond it, twice
    ((1e-5, 1e-5), (FAST, 1e-5), False),                 # beyond it once: the re-timing ties
    ((1e-5, 0.7e-5), (0.6e-5, 0.6e-5), False),           # inside the default's own spread
    ((1e-5, 1e-5), (1e-5,), False),                      # a tie keeps the default
])
def test_a_candidate_must_beat_the_default_by_more_than_the_noise(default_s, challenger_s,
                                                                  wins):
    trials = []
    e = tune_shape(16, 512, 2048, "bfloat16", timer=_margin_timer(default_s, challenger_s),
                   trials=trials)
    default = default_candidate(16, 512, 2048, "bfloat16")
    assert default == (16, 64, 64, "zorder") and trials[0]["blocks"] == default[:3]
    assert len(trials) == len(candidate_space(16, 512, 2048))   # re-timings are no trials
    got = (e.block_m, e.block_n, e.block_k, e.order)
    assert got == ((64, 64, 64, "rowmajor") if wins else default)
    assert e.seconds == (min(challenger_s) if wins else min(default_s))


def test_the_default_is_timed_when_a_bounded_space_leaves_it_out():
    default = default_candidate(16, 512, 2048, "bfloat16")
    sampled = candidate_space(16, 512, 2048, max_candidates=2)
    assert default not in sampled
    timed = []

    def timer(m, n, k, dtype, cand):
        timed.append(cand)
        return 1e-5
    e = tune_shape(16, 512, 2048, "bfloat16", max_candidates=2, timer=timer)
    assert timed == [default, *sampled, default]
    assert (e.block_m, e.block_n, e.block_k, e.order) == default


def test_the_tuning_planned_scope_reaches_linear():
    from repro_torch.layers.linear import linear

    mesh = Mesh((2, 2), device="cpu")
    tuner = Tuner(device="cpu", timer=_fake_timer)
    x = torch.ones(2, 8, 64)
    w = torch.ones(64, 32)
    with port_plan.planned_matmuls(mesh, tuning=tuner):
        assert port_plan.planned_tuning() is tuner
        y = linear(x, w)
    assert port_plan.planned_tuning() is None
    assert tuner.stats["searches"] >= 1 and torch.equal(y, linear(x, w))
    mesh.close()
