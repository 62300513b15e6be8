"""The reference's examples and its Sec. 4.3 model on the port, on the CPU.

The traffic model (``repro_torch.core.zorder``) and ``matmul_time_model``
(``repro_torch.core.cost``) against the reference's functions; the four
examples of ``repro_torch.examples`` with ``--device cpu`` against the
reference's scripts under ``examples/``, each reference script run once in
a subprocess (module-scoped fixtures), as ``tests/test_system.py`` runs
them.  The reference's serving example does not run on this JAX
(``tests/test_system.py::test_serve_example_runs``), so the port's
``--no-mesh`` run is the oracle of its plan-routed run.
"""
import ast
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from unittest import mock

import pytest
import torch

from repro.core import cost as ref_cost
from repro.core import zorder as ref_zorder
from repro_torch.configs import get_smoke_config
from repro_torch.core import cost, zorder
from repro_torch.examples import distributed_matmul, quickstart, serve_batched, train_lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = [(16, 16, 16), (3, 5, 2), (8, 1, 8)]
CACHES = [1, 48, 192, 768]
ORDERS = {"zorder": zorder.zorder_schedule, "rowmajor": zorder.rowmajor_schedule}
STRATEGIES = ("cannon", "summa", "summa+ov", "pod25d", "ring_ag")
# a bf16 product rounded once from fp32 sums: each element within 2^-9 of
# the fp32 product relatively, each row's relative L2 error under twice that
BF16_ROW_TOL = 2.0 ** -8


def _reference_script(name: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, os.path.join(ROOT, "examples", name), *args],
                         capture_output=True, text=True, env=env, timeout=590, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return res.stdout


# -- the Sec. 4.3 traffic model --------------------------------------------------------------


@pytest.mark.parametrize("cache_blocks", CACHES)
@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_block_traffic_equals_the_references(grid, order, cache_blocks):
    mine = ORDERS[order](*grid)
    ref = getattr(ref_zorder, f"{order}_schedule")(*grid)
    assert mine == ref
    assert zorder.block_reuse_distance_traffic(mine, cache_blocks) == \
        ref_zorder.block_reuse_distance_traffic(ref, cache_blocks)
    assert zorder.ideal_traffic(len(mine), cache_blocks) == \
        ref_zorder.ideal_traffic(len(ref), cache_blocks)


@pytest.mark.parametrize("level_bits", [0, 1, 2])
@pytest.mark.parametrize("grid", GRIDS + [(4, 4, 4), (5, 3, 7)],
                         ids=lambda g: "x".join(map(str, g)))
def test_supersteps_equal_the_references(grid, level_bits):
    mine = list(zorder.supersteps(*grid, level_bits))
    assert mine == list(ref_zorder.supersteps(*grid, level_bits))
    assert all(len(s) == 8 ** level_bits for s in mine[:-1])
    assert [c for s in mine for c in s] == zorder.zorder_schedule(*grid)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_grid_index_map_walks_the_zorder(grid):
    mine = zorder.zorder_grid_index_map(*grid)
    ref = ref_zorder.zorder_grid_index_map(*grid)
    steps = grid[0] * grid[1] * grid[2]
    assert [mine(s) for s in range(steps)] == [ref(s) for s in range(steps)]


@pytest.mark.parametrize("cache_blocks", [48, 192])
def test_zorder_beats_rowmajor(cache_blocks):
    """Sec. 4.3, as ``tests/test_core_groups.py`` asserts it for the
    reference: on a 16^3 grid (256 blocks an operand) the space-bounded
    order fetches fewer blocks than the naive one."""
    z = zorder.zorder_schedule(16, 16, 16)
    r = zorder.rowmajor_schedule(16, 16, 16)
    assert zorder.block_reuse_distance_traffic(z, cache_blocks) < \
        zorder.block_reuse_distance_traffic(r, cache_blocks)


@pytest.mark.parametrize("mnk", [(128, 128, 128), (4, 2048, 8192), (32768, 3840, 10240)])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_matmul_time_model_equals_the_references(mnk, dtype_bytes):
    assert cost.matmul_time_model(*mnk, dtype_bytes) == \
        ref_cost.matmul_time_model(*mnk, dtype_bytes)


# -- quickstart ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart_pair():
    return _reference_script("quickstart.py"), quickstart.main(["--device", "cpu"])


def test_quickstart_gives_the_references_solver_numbers(quickstart_pair):
    ref, mine = quickstart_pair
    count, hop = re.search(r"(\d+) valid equivariant schedules; min hop cost (\d+)", ref).groups()
    assert (mine["schedules"], mine["min_hop_cost"]) == (int(count), int(hop))
    movements = re.search(r"best movements: (\{.*\})  cannon-like: (\w+)", ref)
    assert mine["movements"] == ast.literal_eval(movements.group(1))
    assert str(mine["cannon_like"]) == movements.group(2) == "True"
    assert mine["cannon_found"] and "Cannon's own matrix found: True" in ref
    skew = re.search(r"placement of A \(row i=1\): (\[.*\])  <-", ref).group(1)
    assert mine["skew"] == ast.literal_eval(skew)
    words = re.search(r"([\d.e+]+) words/node \(lower bound ([\d.e+]+); factor ([\d.]+)x\)", ref)
    assert (f"{mine['words_per_node']:.3e}", f"{mine['lower_bound']:.3e}",
            f"{mine['factor']:.1f}") == words.groups()
    assert mine["simulated"] and "C == A@B: True" in ref
    assert f"systolic properties: {mine['systolic']}" in ref


def test_quickstart_prints_the_references_lines(quickstart_pair, capsys):
    """Steps 1-3 and the hex array print what the reference prints, line
    for line; step 4 is the card's kernel, not the reference's Pallas."""
    ref, _ = quickstart_pair
    quickstart.main(["--device", "cpu"])
    mine = capsys.readouterr().out
    cut = "\n=== Same algebra, "
    head = ref.split(cut)[:2]
    assert mine.split(cut)[:2] == head


def test_quickstart_kernel_rows_on_the_cpu(quickstart_pair):
    """Step 4 names each type's route (fma for fp32, wide for bf16 at 256
    rows); on the CPU the plain version multiplies and nothing launches."""
    _, mine = quickstart_pair
    assert {name: r["route"] for name, r in mine["k1"].items()} == \
        {"float32": "fma", "bfloat16": "wide"}
    for r in mine["k1"].values():
        assert r["launched"] == {} and r["row_rel"] == 0.0 and r["finite"]


def test_entry_points_refuse_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    for mod in (quickstart, distributed_matmul, serve_batched, train_lm):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main([])


# -- the distributed demo --------------------------------------------------------------------


def _parse_demo(text: str) -> dict:
    rows = {}
    for line in text.splitlines():
        m = re.match(r"(\S+)\s+err=([\d.]+)\s+coll_bytes/dev=([\d.e+]+)(?:\s+by_kind=(\{.*?\}))?",
                     line)
        if m:
            name, err, total, kinds = m.groups()
            rows[name] = {"err": float(err), "total": total,
                          "by_kind": ast.literal_eval(kinds) if kinds else None}
    model = re.search(r"paper cost model: cannon words/node = ([\d.e+]+)", text).group(1)
    return {"rows": rows, "cost_model": model}


@pytest.fixture(scope="module")
def demo():
    ref = _parse_demo(_reference_script("distributed_matmul.py"))
    mine = {dtype: distributed_matmul.main(["--device", "cpu", "--dtype", dtype])
            for dtype in ("float32", "bfloat16")}
    return ref, mine


@pytest.mark.parametrize("name", STRATEGIES)
def test_demo_counts_the_references_bytes_by_kind(demo, name):
    """The reference prints the bytes of its compiled HLO, where XLA's CPU
    compiler has made every bf16 collective an f32 one: the port's fp32
    run counts those bytes, by kind where the reference prints kinds, and
    the same total where it prints only a total."""
    ref, mine = demo
    row, want = mine["float32"]["strategies"][name], ref["rows"][name]
    assert row["ranks"] == (8 if name in ("pod25d", "ring_ag") else 16)
    assert row["same_on_every_rank"]
    assert f"{sum(row['by_kind'].values()):.3e}" == want["total"]
    if want["by_kind"] is not None:
        assert row["by_kind"] == want["by_kind"]
    assert f"{mine['float32']['cost_model']['words_per_node']:.3e}" == ref["cost_model"]


@pytest.mark.parametrize("name", STRATEGIES)
def test_demo_in_bf16_moves_bf16_blocks(demo, name):
    """In bf16 the program moves bf16 blocks, half the fp32 run's bytes of
    each kind; only the 2.5D reduction's all-reduce sums fp32 partials."""
    _, mine = demo
    f32 = mine["float32"]["strategies"][name]["by_kind"]
    bf16 = mine["bfloat16"]["strategies"][name]
    assert bf16["same_on_every_rank"]
    assert bf16["by_kind"] == {k: v if k == "all-reduce" else v // 2 for k, v in f32.items()}


@pytest.mark.parametrize("name", STRATEGIES)
def test_demo_products_within_bf16_rounding(demo, name):
    """Each bf16 product is the fp32 product rounded once to bf16: each
    row within ``BF16_ROW_TOL`` of it (relative L2), the largest error at
    most twice the reference's; the fp32 run equals it to 1e-5."""
    ref_rows, mine = demo
    row = mine["bfloat16"]["strategies"][name]
    out, want = row["out"].float(), row["ref"]
    assert row["out"].dtype == torch.bfloat16
    assert ((out - want).norm(dim=1) / want.norm(dim=1)).max().item() <= BF16_ROW_TOL
    assert row["err"] <= 2 * ref_rows["rows"][name]["err"]
    f32 = mine["float32"]["strategies"][name]
    assert torch.allclose(f32["out"], f32["ref"], rtol=1e-5, atol=1e-4)


# -- serving ---------------------------------------------------------------------------------


def _fp32_smoke_config(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


@pytest.fixture(scope="module")
def served():
    """The example as it runs (bf16), and with its smoke config in fp32,
    where a planned product's other summation order cannot flip a
    near-tied greedy token."""
    runs = {}
    for dtype in ("bfloat16", "float32"):
        for mesh in (True, False):
            argv = ["--device", "cpu"] + ([] if mesh else ["--no-mesh"])
            with mock.patch.object(serve_batched, "get_smoke_config",
                                   _fp32_smoke_config if dtype == "float32"
                                   else get_smoke_config):
                runs[dtype, mesh] = serve_batched.main(argv)
    return runs


@pytest.mark.parametrize("mesh", [True, False], ids=["2x2", "no-mesh"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serving_routes_to_the_warm_bucket(served, dtype, mesh):
    run = served[dtype, mesh]
    assert run["bucket"] == "4x16" and run["dtype"] == dtype
    assert [len(t) for t in run["new_tokens"]] == [16, 16, 16]
    assert len(run["prompts"]) == 3 and all(3 <= len(p) <= 8 for p in run["prompts"])
    if mesh:
        assert run["hit_rate"] == 1.0 and run["mesh"] == {"x": 2, "y": 2}
        assert run["warmup"]["4x16"]["plans"] > 0 and sum(run["strategies"].values()) > 0
    else:
        # nothing is planned, so the plan cache is never looked up
        assert run["hit_rate"] is None and run["strategies"] == {}
        assert run["warmup"]["4x16"]["plans"] == 0


def test_serving_on_the_mesh_gives_the_local_tokens(served):
    """fp32: the plan-routed server's tokens are the local server's."""
    assert served["float32", True]["prompts"] == served["float32", False]["prompts"]
    assert served["float32", True]["new_tokens"] == served["float32", False]["new_tokens"]


# -- training --------------------------------------------------------------------------------

TRAIN_ARGV = ["--preset", "demo", "--steps", "40", "--batch", "4", "--seq", "128",
              "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return {fail: train_lm.main(TRAIN_ARGV + ["--ckpt", str(tmp_path_factory.mktemp("ckpt"))]
                                + (["--inject-failure", "20"] if fail else []))
            for fail in (False, True)}


@pytest.mark.parametrize("fail", [False, True], ids=["uninterrupted", "inject-failure"])
def test_training_demo_loss_decreases(trained, fail):
    run = trained[fail]
    assert run["last_loss"] < run["first_loss"]
    assert run["restarts"] == (1 if fail else 0)
    assert [h["step"] for h in run["history"]] == list(range(5, 41, 5))


def _reference_example(name: str):
    """The module of ``examples/<name>.py`` (its ``main`` runs only as a script)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("preset", ["DEMO", "M100"])
def test_training_demo_presets_are_the_references(preset):
    """The presets copy the reference example's field for field, and count
    its parameters."""
    mine, ref = getattr(train_lm, preset), getattr(_reference_example("train_lm"), preset)
    assert dataclasses.asdict(ref).items() <= dataclasses.asdict(mine).items()
    assert mine.param_count() == ref.param_count()


def test_training_demo_counts_the_references_parameters(trained):
    assert trained[False]["params"] == _reference_example("train_lm").DEMO.param_count()


def test_training_restart_keeps_the_steps_before_the_failure(trained):
    """The failure at step 20 comes after the checkpoint of step 20: the
    logged losses up to it are the uninterrupted run's, bit for bit."""
    before = [h["loss"] for h in trained[False]["history"] if h["step"] <= 20]
    assert [h["loss"] for h in trained[True]["history"] if h["step"] <= 20] == before
