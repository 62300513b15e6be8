"""The port's dry run (``repro_torch.launch.{specs,dryrun,report}``), its
cell probe (``perf_probe --arch``) and the conformance checker's HLO leg,
held against the reference (``repro.launch``, ``repro.verify``) on the CPU.

Tolerances: shapes, types and bytes exact; counts of the one-rank route
equal to the threaded fake run's; tables equal as strings.  The
reference's own dry run fails on this JAX (``ROADMAP.md`` queue 3), so the
oracle of the bytes a rank holds is the arithmetic of the reference's
sharding specs, computed in a subprocess with 512 forced host devices.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from repro.configs import runnable_cells as ref_runnable_cells
from repro.configs import skipped_cells as ref_skipped_cells
from repro.configs import get_config as ref_get_config
from repro.launch import report as ref_report
from repro.launch import specs as ref_specs
from repro_torch.checkpoint.convert import params_to_jax
from repro_torch.configs import (SHAPES, ShapeCell, get_config, get_smoke_config, runnable_cells,
                                 skipped_cells)
from repro_torch.dist import _collectives
from repro_torch.dist.mesh import Mesh
from repro_torch.launch import dryrun, perf_probe, report, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.plan import build_plan
from repro_torch.verify import ConformanceError, check
from repro_torch.verify.conformance import CASES, _overlap_modes, matrix_cells

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = runnable_cells()
# the port's tokens are int64, its index type; the reference's int32
TOKEN_TYPES = {"int64": "int32"}


def test_the_cell_grid_is_the_references():
    assert CELLS == ref_runnable_cells() and skipped_cells() == ref_skipped_cells()
    assert {k: (c.seq_len, c.global_batch, c.kind) for k, c in SHAPES.items()} == {
        k: (c.seq_len, c.global_batch, c.kind) for k, c in ref_specs.SHAPES.items()}


# -- specs: shapes and types against the reference's eval_shape ------------------------


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _sig(tree, port: bool):
    out = {}
    for k, v in _flat(tree):
        dt = str(v.dtype).replace("torch.", "")
        out[k] = (tuple(v.shape), TOKEN_TYPES.get(dt, dt) if port else dt)
    return out


_PORT, _REF = {}, {}


def _abstract(arch):
    if arch not in _PORT:
        _PORT[arch] = specs.abstract_params(get_config(arch), "cpu")
        _REF[arch] = ref_specs.abstract_params(ref_get_config(arch))
    return _PORT[arch], _REF[arch]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_match_the_references_eval_shape(arch, shape):
    (model, params), (ref_model, ref_params) = _abstract(arch)
    assert _sig(params_to_jax(params), True) == _sig(ref_params, False)
    assert _sig(specs.input_specs(arch, shape, "cpu"), True) == \
        _sig(ref_specs.input_specs(arch, shape), False)
    kind = SHAPES[shape].kind
    if kind == "decode":
        cache = specs.abstract_cache(model, get_config(arch), shape, "cpu")
        ref_cache = ref_specs.abstract_cache(ref_model, ref_get_config(arch), shape)
        assert _sig(params_to_jax(cache), True) == _sig(ref_cache, False)
    if kind == "train":
        state = specs.abstract_opt_state(params)
        ref_state = ref_specs.abstract_opt_state(ref_params)
        assert _sig({"step": state["step"], **{k: params_to_jax(state[k])
                                                 for k in ("master", "m", "v")}}, True) == \
            _sig(ref_state, False)


# -- argument bytes a rank holds, against the reference's spec arithmetic -----------------

_REF_BYTES = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, math
import jax
from jax.sharding import NamedSharding
from repro.configs import SHAPES, get_config, runnable_cells
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import abstract_cache, abstract_opt_state, abstract_params, input_specs
from repro.models.sharding_rules import cache_shardings, param_shardings, zero_shardings
from repro.launch.dryrun import _batch_shardings

def per_rank(tree, shardings):
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
               for x, sh in zip(leaves, shs))

out = {}
meshes = {"16x16": make_production_mesh(multi_pod=False),
          "2x16x16": make_production_mesh(multi_pod=True)}
params = {}
for arch, shape in runnable_cells():
    cfg = get_config(arch)
    if arch not in params:
        params[arch] = abstract_params(cfg)
    model, ap = params[arch]
    cell = SHAPES[shape]
    for mid, mesh in meshes.items():
        shard_batch = cell.global_batch >= mesh.shape.get("data", 1)
        batch = input_specs(arch, shape)
        bsh = _batch_shardings(batch, mesh, shard_batch=shard_batch)
        ints = [k for k, v in batch.items() if v.dtype == jax.numpy.int32]
        row = {"batch_int": per_rank({k: batch[k] for k in ints}, {k: bsh[k] for k in ints}),
               "batch_float": per_rank({k: v for k, v in batch.items() if k not in ints},
                                       {k: bsh[k] for k in batch if k not in ints})}
        if cell.kind == "train":
            st = abstract_opt_state(ap)
            osh = zero_shardings(ap, mesh)
            row["state"] = (math.prod(st["step"].shape) * st["step"].dtype.itemsize
                            + sum(per_rank(st[k], osh) for k in ("master", "m", "v")))
        else:
            row["params"] = per_rank(ap, param_shardings(ap, mesh))
        if cell.kind == "decode":
            ac = abstract_cache(model, cfg, shape)
            row["cache"] = per_rank(ac, cache_shardings(ac, mesh, shard_batch=shard_batch))
        out[arch + "|" + shape + "|" + mid] = row
print("BYTES", json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_bytes():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF_BYTES], capture_output=True, text=True,
                         env=env, timeout=900)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("BYTES ")]
    assert line, res.stdout[-2000:] + res.stderr[-3000:]
    return json.loads(line[0][6:])


_MESHES = {}


def _mesh(multi: bool):
    if multi not in _MESHES:
        _MESHES[multi] = make_production_mesh(multi_pod=multi, device="cpu")
    return _MESHES[multi]


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_per_rank_are_the_reference_specs_arithmetic(ref_bytes, arch, shape,
                                                                     multi):
    (model, params), _ = _abstract(arch)
    mesh = _mesh(multi)
    cfg = get_config(arch)
    got = dryrun.argument_bytes(dryrun.cell_arguments(
        model, params, specs.input_specs(arch, shape, "cpu"), cfg, SHAPES[shape], mesh,
        device="cpu"))
    want = ref_bytes[f"{arch}|{shape}|{'2x16x16' if multi else '16x16'}"]
    # the port's tokens are int64, the reference's int32: twice the bytes
    assert got.pop("batch") == 2 * want.pop("batch_int") + want.pop("batch_float")
    assert got == want


# -- the one-rank pricing against every rank's thread ----------------------------------------

ORACLE = [("llama3.2-1b", kind, sh) for kind in ("train", "prefill", "decode")
          for sh in ("2x2", "2x2x2")] + [
    ("zamba2-2.7b", "train", "2x2"), ("zamba2-2.7b", "decode", "2x2x2"),
    ("xlstm-350m", "train", "2x2"), ("xlstm-350m", "prefill", "2x2x2"),
    ("seamless-m4t-medium", "decode", "2x2"), ("seamless-m4t-medium", "train", "2x2"),
    ("deepseek-moe-16b", "prefill", "2x2"), ("minicpm3-4b", "decode", "2x2x2")]
_SMOKE_MESHES = {"2x2": ((2, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("arch,kind,mesh_id", ORACLE)
def test_the_dry_runs_per_rank_count_equals_the_threaded_fake_runs(arch, kind, mesh_id):
    from repro_torch.roofline import hlo_stats

    shape, names = _SMOKE_MESHES[mesh_id]
    mesh = Mesh(shape, names, device="cpu")
    cell = ShapeCell({"train": "train_4k", "prefill": "prefill_32k",
                      "decode": "decode_32k"}[kind], 32, 8, kind)
    cfg = get_smoke_config(arch)
    try:
        one, threads = hlo_stats.Counter(), hlo_stats.Counter()
        priced = dryrun.lower_cell(arch, cell, mesh, cfg=cfg, device="cpu", counter=one)
        oracle = dryrun.lower_cell(arch, cell, mesh, cfg=cfg, device="cpu", threads=True,
                                   counter=threads)
    finally:
        mesh.close()
    assert one.ranks == [0] and threads.ranks == list(range(mesh.size))
    # every rank runs the same programs; rank 0 also stands for the rank
    # that updates its optimizer blocks
    assert all(threads.cost(r) == threads.cost(1) for r in threads.ranks[1:])
    assert (threads.cost(0) == threads.cost(1)) == (kind != "train")
    assert one.cost(0) == threads.cost(0) and one.cost() == threads.cost()
    assert one.cost(0).flops > 0 and one.cost(0).coll_bytes > 0
    priced["counted"].pop("priced"), oracle["counted"].pop("priced")
    assert priced["counted"] == oracle["counted"] and priced["roofline"] == oracle["roofline"]
    assert priced["memory"]["argument_bytes"] == oracle["memory"]["argument_bytes"]


# -- the controller's head- and vocab-parallel work per model-axis shard --------------------

# the dot ops of the counter (``hlo_stats._DOTS``) and K1
_DOT_OPS = {"aten::mm", "aten::bmm", "aten::dot", "aten::mv", "aten::addmm", "aten::baddbmm",
            "aten::addmv", "repro_torch::zorder_matmul"}
# the old per-chip rule's peak for Llama-3.2-1B's train_4k on (16, 16)
OLD_TRAIN_4K_PEAK = 1283 * 2 ** 30


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_model_sharded_controller_work_is_the_reference_specs_arithmetic(shape):
    """Llama-3.2-1B on the (16, 16) production mesh: the dot FLOPs of the
    controller's model-sharded part, per model-axis shard, are the closed
    forms of the reference's specs (``repro.launch.specs``: the batch, the
    cache's slots; its config's heads, head dim and padded vocabulary):
    the unembedding (and in training its two backward products) over the
    vocabulary's shards, the attention core's two einsums a layer (and in
    training their four backward products) over the query heads' shards.
    The unembedding's K1 bytes are its operands' and output's per shard."""
    from repro.layers.embed import padded_vocab as ref_padded_vocab
    from repro_torch.roofline import hlo_stats

    arch, model = "llama3.2-1b", 16
    cfg = ref_get_config(arch)
    batch = ref_specs.input_specs(arch, shape)
    b, s = batch["tokens"].shape
    vp = ref_padded_vocab(cfg.vocab_size)
    heads, vocab = math.gcd(cfg.num_heads, model), math.gcd(vp, model)
    kind = SHAPES[shape].kind
    if kind == "decode":
        keys = jax_shape(ref_specs.abstract_cache(ref_specs.abstract_params(cfg)[0], cfg,
                                                  shape))
        queries = 1
    else:
        keys = queries = s
    tokens = b * queries
    core = 2 * b * cfg.num_heads * queries * keys * cfg.head_dim   # QKᵀ or PV
    passes = 3 if kind == "train" else 1   # forward; dA and dB in training
    want = (passes * 2 * tokens * cfg.d_model * vp / vocab
            + cfg.num_layers * passes * 2 * core / heads)
    counter = hlo_stats.Counter()
    rec = dryrun.lower_cell(arch, shape, _mesh(False), device="cpu", counter=counter)
    got = sum(c.flops for name, c in counter.split_by_op.items() if name in _DOT_OPS)
    assert got == pytest.approx(want, rel=1e-12)
    k1 = counter.split_by_op[hlo_stats.K1_OP]
    assert k1.bytes == pytest.approx((tokens * cfg.d_model * 2 + cfg.d_model * vp * 2
                                      + tokens * vp * 4) / vocab, rel=1e-12)
    sharded = rec["counted"]["model_sharded"]
    assert sharded["shards"] == {"heads": heads, "kv_heads": math.gcd(cfg.num_kv_heads, model),
                                 "vocab": vocab} == {"heads": 16, "kv_heads": 8, "vocab": 16}
    assert sharded["per_shard"]["flops"] < sharded["whole"]["flops"] / 8
    assert rec["counted"]["rule"] == ("per chip = rank_program + (controller + model_sharded "
                                      "/ shards) / ways")
    if shape == "train_4k":
        # the old rule (the controller's work and live bytes over the batch
        # ways alone) read 1283 GiB a rank
        assert rec["memory"]["peak_bytes"] < OLD_TRAIN_4K_PEAK / 4


def jax_shape(cache) -> int:
    """The slots of a reference decode cache (its K cache's sequence dim)."""
    return int(next(v for k, v in _flat(cache) if k[-1] == "k").shape[2])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-20b"])    # tied, untied head
def test_a_decode_peak_holds_no_fp32_copy_of_the_head(arch):
    """The smoke model with a 32768-token vocabulary, so the bf16 head
    (4 MiB) outweighs every other tensor of a decode step: the step's
    predicted peak stays within the arguments plus less than the head's
    fp32 size, which a cast of the head (8 MiB) would pass by itself."""
    cfg = dataclasses.replace(get_smoke_config(arch), vocab_size=32768)
    rec = dryrun.lower_cell(arch, ShapeCell("decode_32k", 32, 2, "decode"), None, cfg=cfg,
                            device="cpu")
    head_fp32 = 32768 * cfg.d_model * 4
    extra = rec["memory"]["peak_bytes"] - rec["memory"]["argument_bytes"]
    assert 0 < extra < head_fp32 // 4, (extra, head_fp32)


def test_a_cell_on_one_device_counts_the_trainers_step_whole():
    from repro_torch.roofline import hlo_stats

    counter = hlo_stats.Counter()
    cfg = get_smoke_config("llama3.2-1b")
    rec = dryrun.lower_cell("llama3.2-1b", ShapeCell("train_4k", 32, 4, "train"), None,
                            cfg=cfg, device="cpu", counter=counter)
    assert counter.ranks == [] and rec["chips"] == 1 and rec["counted"]["ways"] == 1
    # every projection's forward, dA and dB: 3 x 7 K1 products a layer; the
    # unembedding's forward (its bf16 operands meet the fp32 cotangent in
    # fp32 products outside K1, as the reference's XLA products)
    assert counter.calls[hlo_stats.K1_OP] == 3 * 7 * cfg.num_layers + 1
    n = cfg.param_count()
    assert rec["memory"]["argument_bytes"] == 4 + 3 * 4 * n + 2 * 4 * 32 * 8
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]
    assert rec["memory"]["fits_card"] and rec["roofline"]["flops_per_chip"] > \
        rec["roofline"]["model_flops"]


# -- report.py -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def records():
    cfg = get_smoke_config("llama3.2-1b")
    out = []
    for kind, shape in (("train", "train_4k"), ("decode", "decode_32k")):
        for sh, names in (((2, 2), ("data", "model")), ((4, 4), ("data", "model"))):
            mesh = Mesh(sh, names, device="cpu")
            rec = dryrun.lower_cell("llama3.2-1b", ShapeCell(shape, 32, 8, kind), mesh,
                                    cfg=cfg, device="cpu")
            rec["ok"] = True
            out.append(rec)
    out.append({"arch": "x", "shape": "y", "mesh": "16x16", "ok": False, "error": "E"})
    return json.loads(json.dumps(out))


def _without_capacity(table: str) -> str:
    """Each row without its sixth column (the capacity column)."""
    return "\n".join("|".join(c for i, c in enumerate(row.split("|")) if i != 6)
                     for row in table.splitlines())


@pytest.mark.parametrize("mesh", ["2x2", "4x4"])
def test_roofline_table_renders_the_references_string(records, mesh):
    assert report.roofline_table(records, mesh) == ref_report.roofline_table(records, mesh)


def test_dryrun_table_renders_the_references_string_but_the_capacity_column(records):
    ours, theirs = report.dryrun_table(records), ref_report.dryrun_table(records)
    assert _without_capacity(ours) == _without_capacity(theirs)
    assert "fits 80G" in ours and "fits 16G" in theirs
    assert [row.split("|")[6].strip() for row in ours.splitlines()[2:]] == ["Y"] * 4


def test_plan_cache_serve_sweep_and_kernel_tables_render_the_references_strings():
    info = {"hits": 3, "misses": 1, "currsize": 4, "maxsize": 1024, "evictions": 0}
    assert report.plan_cache_table(info) == ref_report.plan_cache_table(info)
    assert report.plan_cache_table() != ""           # the port's live counters
    sweep = {"cells": [
        {"ok": True, "mesh": "2x2", "bucket": "4x16", "strategy": "ring_ag", "routed": True,
         "tokens_per_s": 700.5, "tokens_per_s_per_device": 175.1, "ttft_ms": 6.7,
         "p50_ms": 5.2, "p99_ms": None, "cache_hit_rate": 0.98, "match_baseline": True},
        {"ok": False, "mesh": "4", "bucket": "8x32", "strategy": "cannon",
         "error": "Traceback\nValueError: no"}]}
    assert report.serve_sweep_table(sweep) == ref_report.serve_sweep_table(sweep)
    metrics = {"kernel.matmul.us": {"count": 3, "mean": 12.5, "min": 10.0, "max": 15.0}}
    assert report.kernel_metrics_table(metrics) == ref_report.kernel_metrics_table(metrics)
    assert report.kernel_metrics_table({}) == ref_report.kernel_metrics_table({})


def test_report_main_prints_every_table(records, tmp_path, capsys):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps({"cells": records, "skipped": skipped_cells()}))
    with mock.patch.object(sys, "argv", ["report", str(path)]):
        report.main()
    out = capsys.readouterr().out
    for head in ("### Roofline", "### Dry-run record", "### Skipped cells", "### Plan cache"):
        assert head in out


# -- the conformance checker's HLO leg ------------------------------------------------------


@pytest.mark.parametrize("strategy,shape,names", matrix_cells(16),
                         ids=[f"{s}-{'x'.join(map(str, sh))}" for s, sh, _ in matrix_cells(16)])
def test_hlo_leg_passes_the_cpu_catalog(strategy, shape, names):
    mesh = Mesh(shape, names, device="cpu")
    try:
        for case, spec in CASES.items():
            for dtype in (torch.float32, torch.bfloat16):
                for mode in _overlap_modes(strategy, shape):
                    plan = build_plan(spec["m"], spec["n"], spec["k"], mesh=mesh,
                                      strategy=strategy, batch=spec["batch"], a_dtype=dtype,
                                      b_dtype=dtype, overlap=mode)
                    rep = check(plan, hlo=True)
                    assert rep.hlo_collective_bytes > 0
    finally:
        mesh.close()


def test_run_matrix_runs_the_hlo_leg():
    from repro_torch.verify import run_matrix

    rows = run_matrix(measure=False, hlo=True, cases=["ragged"], dtypes=[torch.float32],
                      num_devices=4, device="cpu")
    assert len(rows) > 5 and all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
    with _collectives_dropped():
        rows = run_matrix(measure=False, hlo=True, cases=["square"], dtypes=[torch.float32],
                          num_devices=4, device="cpu")
    assert rows and all("[hlo]" in r["error"] for r in rows)


@contextlib.contextmanager
def _collectives_dropped():
    """A program whose collectives move nothing: each returns its own
    block (all_gather repeats it), and nothing reaches the seam."""
    def all_gather(x, axis_name, *, axis, tiled):
        g = _collectives.axis_size(axis_name)
        return torch.cat([x] * g, dim=axis) if tiled else torch.stack([x] * g, dim=axis)

    with mock.patch.object(_collectives, "ppermute", lambda x, axis_name, perm: x), \
            mock.patch.object(_collectives, "ppermute_start", lambda x, axis_name, perm: x), \
            mock.patch.object(_collectives, "ppermute_done", lambda started: started), \
            mock.patch.object(_collectives, "psum", lambda x, axis_name: x), \
            mock.patch.object(_collectives, "all_gather", all_gather):
        yield


@pytest.mark.parametrize("strategy,shape,names", [("cannon", (2, 2), ("x", "y")),
                                                  ("summa", (2, 2), ("x", "y")),
                                                  ("ring_rs", (4,), ("t",)),
                                                  ("pod25d", (2, 2, 2), ("pod", "x", "y"))])
def test_hlo_leg_fails_a_program_that_drops_its_collectives(strategy, shape, names):
    mesh = Mesh(shape, names, device="cpu")
    try:
        plan = build_plan(24, 24, 24, mesh=mesh, strategy=strategy)
        assert check(plan, hlo=True).hlo_collective_bytes > 0
        with _collectives_dropped(), pytest.raises(ConformanceError, match=r"\[hlo\]"):
            check(plan, hlo=True)
    finally:
        mesh.close()


# -- the CLIs -------------------------------------------------------------------------------

PROBE_KEYS = {"tag", "arch", "shape", "dominant", "compute_s", "memory_s", "collective_s",
              "step_bound_s", "roofline_fraction", "coll_by_kind", "peak_GiB"}


def test_perf_probe_arch_prints_the_references_json_keys(tmp_path, capsys):
    out = tmp_path / "perf_iterations.json"
    rc = perf_probe.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--device", "cpu",
                          "--set", "num_layers=2", "d_model=256", "num_heads=4",
                          "num_kv_heads=2", "head_dim=64", "d_ff=512", "vocab_size=1024",
                          "--naive-analyzer", "--tag", "smoke", "--out", str(out)])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == PROBE_KEYS and printed["tag"] == "smoke"
    assert set(printed["coll_by_kind"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                            "all-to-all", "collective-permute"}
    rec = json.loads(out.read_text())[-1]
    assert rec["analyzer"] == "naive" and rec["mesh"] == "16x16"
    assert rec["overrides"]["num_layers"] == 2 and rec["roofline"]["memory_s"] > 0


def test_dryrun_cli_counts_both_production_meshes_within_120s(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "xlstm-350m", "--shape", "decode_32k", "--device", "cpu", "--out",
                          str(out)], capture_output=True, text=True, env=env, timeout=300)
    secs = time.perf_counter() - t0
    assert res.returncode == 0, res.stderr[-3000:]
    assert secs < 120, secs
    data = json.loads(out.read_text())
    assert [(c["mesh"], c["ok"]) for c in data["cells"]] == [("16x16", True), ("2x16x16", True)]
    assert data["skipped"] == [list(s) for s in skipped_cells()]
    assert "2/2 cells compiled" in res.stdout   # the reference's line
    for c in data["cells"]:
        assert c["memory"]["fits_card"] and c["roofline"]["collective_bytes_per_chip"] > 0
        assert math.isclose(c["chips"], 256 if c["mesh"] == "16x16" else 512)
