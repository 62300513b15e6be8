"""The port's per-rank schedule programs on a single-controller CPU mesh.

Each mesh rank is a thread of this process (``repro_torch.dist.Mesh`` with
``device="cpu"``), every rank's block product the K1 plain version.  The
reference: one JAX subprocess on 16 forced host devices (the flag set
before JAX is imported, as ``tests/test_dist.py`` does) runs the JAX
package's ``symmetric_matmul`` for every strategy, staged and overlapped,
on divisible fp32 problems; the port must match it within
``tests/test_dist.py``'s 2e-5.  Where the reference cannot serve as the
oracle on this JAX (ragged and batched problems, the fat-tree slice-back,
``pod25d`` on a one-axis mesh) the oracle is the numpy fp64 product.
"""
import contextlib
import json
import os
import subprocess
import sys
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.dist import Mesh, _collectives, symmetric_matmul
from repro_torch.dist.local import local_matmul
from repro_torch.plan import build_plan, execute_plan, lower_dist, planned_matmuls, spmd
from repro_torch.plan.lower_dist import executions_snapshot, reset_executions
from repro_torch.layers.linear import linear

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5           # tests/test_dist.py
TWIN_TOL = 1e-5      # tests/test_overlap.py's staged-vs-overlapped allclose
BF16_ROW_TOL = 1e-2
SHAPES = [(32, 64, 48)]     # (M, K, N), divisible by every grid here
NAMES = {(2, 2): ("x", "y"), (4,): ("t",), (2, 4): ("x", "y"), (4, 4): ("x", "y"),
         (2, 2, 2): ("pod", "x", "y")}
# (mesh sizes, strategy, overlap): every strategy, staged and overlapped
# where the lowering has both, that the reference runs on this JAX
CELLS = [((2, 2), "cannon", False), ((2, 2), "cannon", True),
         ((2, 2), "summa", False), ((2, 2), "summa", True),
         ((2, 2), "ring_ag", None), ((2, 2), "ring_rs", None),
         ((4,), "ring_ag", None), ((4,), "ring_rs", None),
         ((2, 4), "summa", False), ((2, 4), "summa", True),
         ((4, 4), "cannon", False), ((4, 4), "cannon", True),
         ((2, 2, 2), "cannon25d", False), ((2, 2, 2), "cannon25d", True),
         ((2, 2, 2), "pod25d", False), ((2, 2, 2), "pod25d", True),
         ((2, 2, 2), "fattree", None)]


def _cell_id(cell):
    sizes, s, ov = cell
    return f"{s}-{'x'.join(map(str, sizes))}-{ {None: 'default', False: 'staged', True: 'ov'}[ov]}"


def _operands(shape, seed=0, batch=()):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(batch + (m, k), dtype=np.float32),
            rng.standard_normal((k, n), dtype=np.float32))


_REF_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax, jax.numpy as jnp, numpy as np
from repro.dist import symmetric_matmul

inp, out_path = sys.argv[1], sys.argv[2]
data = dict(np.load(inp))
cells = json.loads(data.pop("cells").tobytes().decode())
devs = np.array(jax.devices())
meshes = {}
out = {}
for key, sizes, names, strategy, overlap, shape in cells:
    sizes, names = tuple(sizes), tuple(names)
    if (sizes, names) not in meshes:
        meshes[sizes, names] = jax.make_mesh(sizes, names, devices=devs[:int(np.prod(sizes))])
    a, b = data[f"a{shape}"], data[f"b{shape}"]
    out[key] = np.asarray(symmetric_matmul(jnp.asarray(a), jnp.asarray(b),
                                           mesh=meshes[sizes, names], strategy=strategy,
                                           overlap=overlap))
np.savez(out_path, **out)
print("REF_OK")
"""


def _key(cell, si):
    return f"{_cell_id(cell)}-s{si}"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's outputs for every (cell, shape), from one
    subprocess on 16 forced host devices."""
    d = tmp_path_factory.mktemp("ref")
    cells = [[_key(c, si), list(c[0]), list(NAMES[c[0]]), c[1], c[2], si]
             for c in CELLS for si in range(len(SHAPES))]
    arrays = {}
    for si, shape in enumerate(SHAPES):
        arrays[f"a{si}"], arrays[f"b{si}"] = _operands(shape, seed=si)
    np.savez(d / "in.npz", cells=np.frombuffer(json.dumps(cells).encode(), np.uint8), **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(d / "in.npz"),
                          str(d / "out.npz")], capture_output=True, text=True, env=env,
                         timeout=600)
    assert "REF_OK" in res.stdout, res.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _mesh(sizes, names=None):
    return Mesh(sizes, names or NAMES[tuple(sizes)], device="cpu")


@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
def test_strategy_matches_reference(reference, cell):
    sizes, strategy, overlap = cell
    mesh = _mesh(sizes)
    for si, shape in enumerate(SHAPES):
        a, b = _operands(shape, seed=si)
        out = symmetric_matmul(torch.from_numpy(a), torch.from_numpy(b), mesh=mesh,
                               strategy=strategy, overlap=overlap)
        ref = reference[_key(cell, si)]
        assert out.shape == ref.shape and out.dtype == torch.float32
        assert np.max(np.abs(out.numpy() - ref)) < TOL, (cell, shape)


TWINS = [((2, 2), "cannon"), ((4, 4), "cannon"), ((2, 2), "summa"), ((2, 4), "summa"),
         ((4, 4), "summa"), ((2, 2, 2), "cannon25d"), ((2, 2, 2), "pod25d")]


@pytest.mark.parametrize("sizes, strategy", TWINS,
                         ids=[f"{s}-{'x'.join(map(str, z))}" for z, s in TWINS])
def test_staged_and_overlapped_twins_agree(sizes, strategy):
    mesh = _mesh(sizes)
    a, b = (torch.from_numpy(x) for x in _operands((48, 64, 32), seed=3))
    staged = symmetric_matmul(a, b, mesh=mesh, strategy=strategy, overlap=False)
    over = symmetric_matmul(a, b, mesh=mesh, strategy=strategy, overlap=True)
    np.testing.assert_allclose(staged.numpy(), over.numpy(), rtol=TWIN_TOL, atol=TWIN_TOL)
    if strategy in ("cannon", "cannon25d"):   # a pure reorder of the same operations
        assert torch.equal(staged, over)


# every body that defers its prefetches (ring_ag has no staged twin), on
# thread meshes of 2x2, 4 and 2x2x2
DEFERRED = [((2, 2), "cannon"), ((2, 2), "summa"), ((2, 2), "ring_ag"), ((4,), "ring_ag"),
            ((2, 2, 2), "cannon25d"), ((2, 2, 2), "pod25d")]


@contextlib.contextmanager
def done_at_start():
    """Each deferred ppermute finished right after its start: the
    overlapped bodies' blocking twin (the order before deferred permutes)."""
    start, done = _collectives.ppermute_start, _collectives.ppermute_done
    with mock.patch.object(_collectives, "ppermute_start",
                           lambda x, axis_name, perm: done(start(x, axis_name, perm))), \
            mock.patch.object(_collectives, "ppermute_done", lambda finished: finished):
        yield


@pytest.mark.parametrize("sizes, strategy", DEFERRED,
                         ids=[f"{s}-{'x'.join(map(str, z))}" for z, s in DEFERRED])
def test_deferred_permutes_are_bitwise_their_blocking_twin(sizes, strategy):
    """Each overlapped body starts its prefetches and finishes them later
    (as many dones as starts, at least one); its output is bitwise the
    same body's with every done moved right after its start (against the
    staged body: ``test_staged_and_overlapped_twins_agree``)."""
    mesh = _mesh(sizes)
    a, b = (torch.from_numpy(x) for x in _operands((48, 64, 32), seed=5))
    overlap = None if strategy == "ring_ag" else True
    calls = {"start": 0, "done": 0}
    start, done = _collectives.ppermute_start, _collectives.ppermute_done

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    with mock.patch.object(_collectives, "ppermute_start", counted("start", start)), \
            mock.patch.object(_collectives, "ppermute_done", counted("done", done)):
        deferred = symmetric_matmul(a, b, mesh=mesh, strategy=strategy, overlap=overlap)
    assert calls["start"] == calls["done"] > 0
    with done_at_start():
        twin = symmetric_matmul(a, b, mesh=mesh, strategy=strategy, overlap=overlap)
    assert torch.equal(deferred, twin)
    assert (deferred.double() - a.double() @ b.double()).abs().max() < TOL


# (mesh sizes, names, strategy, overlap, operand shape (M, K, N), batch)
ORACLE_CASES = {
    "cannon-ragged": ((2, 2), None, "cannon", None, (30, 27, 19), ()),
    "summa-ragged": ((2, 4), None, "summa", False, (21, 33, 14), ()),
    "summa-ov-ragged": ((2, 4), None, "summa", True, (21, 33, 14), ()),
    "ring_ag-ragged": ((4,), None, "ring_ag", None, (10, 9, 7), ()),
    "ring_rs-ragged": ((2, 2), None, "ring_rs", None, (10, 9, 7), ()),
    "cannon25d-ragged": ((2, 2, 2), None, "cannon25d", True, (13, 29, 11), ()),
    "pod25d-ragged": ((2, 2, 2), None, "pod25d", False, (13, 29, 11), ()),
    "fattree-ragged": ((2, 2, 2), ("tree", "x", "y"), "fattree", None, (30, 27, 19), ()),
    "fattree-4pods": ((4, 2, 2), ("tree", "x", "y"), "fattree", None, (32, 64, 48), ()),
    "pod25d-slab-4": ((4,), ("pod",), "pod25d", None, (16, 40, 12), ()),
    "pod25d-slab-2-ragged": ((2,), ("pod",), "pod25d", None, (15, 7, 9), ()),
    "cannon-batched": ((2, 2), None, "cannon", None, (6, 16, 12), (3,)),
    "ring_rs-batched": ((4,), None, "ring_rs", None, (5, 16, 8), (2, 3)),
    "fattree-batched": ((2, 2, 2), ("tree", "x", "y"), "fattree", None, (7, 16, 8), (2,)),
    "ranked-batched": ((2, 2), None, None, None, (4, 64, 128), (2,)),
    "summa-4x4": ((4, 4), None, "summa", False, (64, 32, 16), ()),
    "summa-ov-4x4": ((4, 4), None, "summa", True, (64, 32, 16), ()),
    "ring_rs-4x4": ((4, 4), None, "ring_rs", None, (64, 32, 16), ()),
    "ring_ag-2x2x2": ((2, 2, 2), None, "ring_ag", None, (64, 32, 16), ()),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_strategy_matches_fp64_product(case):
    sizes, names, strategy, overlap, shape, batch = ORACLE_CASES[case]
    mesh = _mesh(sizes, names)
    a, b = _operands(shape, seed=7, batch=batch)
    out = symmetric_matmul(torch.from_numpy(a), torch.from_numpy(b), mesh=mesh,
                           strategy=strategy, overlap=overlap)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out.numpy() - ref)) < TOL


FACADES = {
    "cannon_matmul": ((2, 2), None, "cannon", {}),
    "summa_matmul": ((2, 4), None, "summa", {"overlap": False}),
    "torus_schedule_matmul": ((2, 2), None, "cannon", {}),
    "cannon25d_matmul": ((2, 2, 2), None, "cannon25d", {}),
    "pod25d_matmul": ((2, 2, 2), None, "pod25d", {}),
    "pod25d_matmul-slab": ((2,), ("pod",), "pod25d", {}),
    "fattree_matmul": ((2, 2, 2), ("tree", "x", "y"), "fattree", {}),
}


@pytest.mark.parametrize("name", sorted(FACADES))
def test_entry_points_are_facades_over_the_plan_engine(name):
    """The strategy entry points build the plan ``symmetric_matmul`` pins
    (axes defaults, padding, specs): bitwise-equal outputs."""
    from repro_torch import dist
    from repro_torch.core.schedule import cannon_schedule

    sizes, names, strategy, kw = FACADES[name]
    mesh = _mesh(sizes, names)
    a, b = (torch.from_numpy(x) for x in _operands((30, 27, 19), seed=9))
    fn = getattr(dist, name.split("-")[0])
    if name == "torus_schedule_matmul":
        out = fn(a, b, cannon_schedule(2), mesh=mesh)
    else:
        out = fn(a, b, mesh=mesh, **kw)
    assert torch.equal(out, symmetric_matmul(a, b, mesh=mesh, strategy=strategy,
                                             overlap=kw.get("overlap")))


def test_batched_both_operands():
    mesh = _mesh((2, 2))
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 8, 12), dtype=np.float32)
    b = rng.standard_normal((3, 12, 4), dtype=np.float32)
    out = symmetric_matmul(torch.from_numpy(a), torch.from_numpy(b), mesh=mesh,
                           strategy="summa")
    np.testing.assert_allclose(out.numpy(), np.einsum("bmk,bkn->bmn", a, b), atol=TOL)
    with pytest.raises(ValueError):
        symmetric_matmul(torch.from_numpy(a), torch.zeros(2, 12, 4), mesh=mesh)
    with pytest.raises(ValueError, match="contraction"):
        symmetric_matmul(torch.from_numpy(a), torch.zeros(8, 4), mesh=mesh)


def _rows_rel(out, ref):
    d = (out.double() - ref.double()).norm(dim=-1)
    return (d / ref.double().norm(dim=-1).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("cell", [c for c in CELLS if c[1] != "ring_ag" or c[0] == (4,)],
                         ids=_cell_id)
def test_bf16_rows_match_local_matmul(cell):
    """bf16 operands, bf16 output: every output row within 1e-2 relative
    L2 of the port's one-rank ``local_matmul`` on the same operands."""
    sizes, strategy, overlap = cell
    a, b = (torch.from_numpy(x).to(torch.bfloat16) for x in _operands((64, 96, 48), seed=11))
    out = symmetric_matmul(a, b, mesh=_mesh(sizes), strategy=strategy, overlap=overlap)
    assert out.dtype == torch.bfloat16
    assert _rows_rel(out, local_matmul(a, b, out_dtype=torch.bfloat16)) <= BF16_ROW_TOL


def _wrong_ring_ag(axis):
    """``ring_ag_matmul`` writing each resident chunk to the wrong row slot."""
    def body(x, w):
        n, idx = _collectives.axis_size(axis), _collectives.axis_index(axis)
        chunk = x.shape[0]
        out = torch.zeros(n * chunk, w.shape[1], dtype=torch.float32)
        cur = x
        for s in range(n):
            nxt = _collectives.ppermute(cur, axis, [(d, (d + 1) % n) for d in range(n)]) \
                if s < n - 1 else None
            src = (idx + s) % n           # the right slot is (idx - s) % n
            out[src * chunk:(src + 1) * chunk] = local_matmul(cur, w, out_dtype=torch.float32)
            cur = nxt
        return out
    return body


@pytest.mark.parametrize("wrong", ["cannon_without_b_skew", "ring_ag_wrong_slot"])
def test_wrong_schedule_fails(wrong):
    """The checks can tell a wrong program: the right one matches, a
    permutation changed by one step lands far outside the tolerance."""
    a, b = (torch.from_numpy(x) for x in _operands((32, 64, 48), seed=1))
    ref = a.double() @ b.double()
    if wrong == "cannon_without_b_skew":
        mesh = _mesh((2, 2))
        plan = build_plan(32, 48, 64, mesh=mesh, strategy="cannon", use_cache=False)
        import dataclasses

        broken = dataclasses.replace(plan, torus=dataclasses.replace(plan.torus, skew_b=()))
        good, bad = lower_dist(plan)(a, b), lower_dist(broken)(a, b)
    else:
        mesh = _mesh((4,))
        spec = ((("t",), None), (None, ("t",)), (None, ("t",)))
        good = symmetric_matmul(a, b, mesh=mesh, strategy="ring_ag")
        bad = spmd(_wrong_ring_ag("t"), mesh, spec[:2], spec[2])(a, b)
    assert (good.double() - ref).abs().max() < TOL
    assert (bad.double() - ref).abs().max() > 1.0


# -- the mesh and the single-controller communicator --------------------------------------


def test_mesh_numbers_ranks_row_major():
    mesh = Mesh((2, 2, 2), ("pod", "x", "y"), device="cpu")
    assert mesh.size == 8 and mesh.shape == {"pod": 2, "x": 2, "y": 2}
    assert mesh.coords(5) == (1, 0, 1) and mesh.rank_of((1, 0, 1)) == 5
    assert mesh.group(5, "y") == (4, 5) and mesh.group(5, "pod") == (1, 5)
    # a tuple of axes: the first name major, in the order given
    assert mesh.group(0, ("pod", "y")) == (0, 1, 4, 5)
    assert mesh.group(0, ("y", "pod")) == (0, 4, 1, 5)
    assert mesh.axis_index(5, ("x", ("y"))) == 1 and mesh.axis_index(6, ("pod", "x")) == 3
    assert mesh.groups("x") == ((0, 2), (1, 3), (4, 6), (5, 7))
    assert [d.id for d in mesh.devices.flat] == list(range(8))
    with pytest.raises(ValueError, match="axis names"):
        Mesh((2, 2), ("x", "x"), device="cpu")


def test_collectives_follow_lax_semantics():
    mesh = Mesh((2, 3), ("x", "y"), device="cpu")

    def body(x):
        me = _collectives.axis_index(("x", "y"))
        shifted = _collectives.ppermute(x, "y", [(0, 1), (1, 2)])   # nobody sends to 0
        gathered = _collectives.all_gather(x, "y", axis=0, tiled=True)
        stacked = _collectives.all_gather(x, ("x", "y"), axis=0, tiled=False)
        total = _collectives.psum(x, "x")
        return torch.stack([shifted[0], gathered.sum(), stacked[:, 0].sum(),
                            total[0], torch.tensor(float(me))])

    args = {r: (torch.full((2,), float(r)),) for r in range(6)}
    outs = mesh.run(body, args)
    for r, o in outs.items():
        x, y = mesh.coords(r)
        assert o[0] == (0.0 if y == 0 else float(r - 1))
        assert o[1] == 2 * sum(mesh.group(r, "y"))
        assert o[2] == sum(range(6))
        assert o[3] == sum(mesh.group(r, "x"))
        assert o[4] == r


def test_failing_rank_raises_in_caller_and_others_do_not_hang():
    mesh = Mesh((2, 2), device="cpu")

    def body(x):
        if _collectives.axis_index(("x", "y")) == 2:
            raise ZeroDivisionError("rank 2 fails")
        return _collectives.psum(x, ("x", "y"))

    with pytest.raises(ZeroDivisionError, match="rank 2"):
        mesh.run(body, {r: (torch.ones(1),) for r in range(4)})
    # the mesh still runs afterwards
    assert mesh.run(lambda x: _collectives.psum(x, "x"),
                    {r: (torch.ones(1),) for r in range(4)})[0].item() == 2.0


def test_rank_that_skips_a_collective_is_detected():
    mesh = Mesh((2,), ("t",), device="cpu")

    def body(x):
        if _collectives.axis_index("t") == 0:
            return x
        return _collectives.psum(x, "t")

    with pytest.raises(_collectives.RankAborted, match="returned while others wait"):
        mesh.run(body, {r: (torch.ones(1),) for r in range(2)})


@pytest.mark.parametrize("misuse", ["never finished", "finished twice"])
def test_a_misused_permute_handle_raises(misuse):
    """A program that returns with a deferred ppermute not finished, or
    finishes one twice, fails the run; the mesh runs on afterwards."""
    mesh = Mesh((2,), ("t",), device="cpu")

    def body(x):
        started = _collectives.ppermute_start(x, "t", [(0, 1), (1, 0)])
        if misuse == "finished twice":
            _collectives.ppermute_done(started)
            return _collectives.ppermute_done(started)
        return x

    match = "already finished" if misuse == "finished twice" else "never finished"
    with pytest.raises(RuntimeError, match=match):
        mesh.run(body, {r: (torch.full((2,), float(r)),) for r in range(2)})
    outs = mesh.run(lambda x: _collectives.ppermute_done(
        _collectives.ppermute_start(x, "t", [(0, 1), (1, 0)])),
        {r: (torch.full((2,), float(r)),) for r in range(2)})
    assert [o[0].item() for o in outs.values()] == [1.0, 0.0]


def test_collective_outside_a_rank_raises():
    with pytest.raises(RuntimeError, match="outside a per-rank program"):
        _collectives.psum(torch.ones(1), "x")


def test_collective_bytes_count_received_words():
    """Cannon on 2x2 at (32, 64) x (64, 48) fp32: the skews and one step
    move A and B blocks; the count is what the ranks received."""
    mesh = _mesh((2, 2))
    a, b = (torch.from_numpy(x) for x in _operands((32, 64, 48), seed=1))
    _collectives.reset_stats()
    symmetric_matmul(a, b, mesh=mesh, strategy="cannon", overlap=False)
    a_blk, b_blk = 16 * 32 * 4, 32 * 24 * 4
    # skew: 2 of 4 ranks receive an A block, 2 a B block; one step: all 4 both
    assert _collectives.stats["ppermute"]["bytes"] == 2 * a_blk + 2 * b_blk + 4 * (a_blk + b_blk)
    assert _collectives.stats["all_gather"]["calls"] == 0


def test_concurrent_products_on_one_mesh_serialise():
    mesh = _mesh((2, 2))
    a, b = (torch.from_numpy(x) for x in _operands((32, 64, 48), seed=2))
    ref = symmetric_matmul(a, b, mesh=mesh, strategy="summa")
    outs = [None] * 4

    def go(i):
        outs[i] = symmetric_matmul(a, b, mesh=mesh, strategy="summa")

    ts = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert all(o is not None and torch.equal(o, ref) for o in outs)


def test_linear_routes_through_the_plan_engine():
    mesh = _mesh((2, 2))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 32), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 24), dtype=np.float32))
    reset_executions()
    local = linear(x, w)
    assert executions_snapshot() == {}
    with planned_matmuls(mesh, strategy="summa"):
        planned = linear(x, w)
    assert executions_snapshot() == {"summa+ov": 1}
    np.testing.assert_allclose(planned.numpy(), local.numpy(), atol=TOL)
    # one-rank meshes and no scope stay local
    with planned_matmuls(_mesh((1,), ("t",))):
        linear(x, w)
    assert executions_snapshot() == {"summa+ov": 1}


def test_local_plan_runs_local_matmul_with_batch_fold():
    a = torch.randn(3, 5, 7)
    b = torch.randn(7, 4)
    plan = build_plan(5, 4, 7, batch=(3,))
    assert plan.strategy == "local"
    np.testing.assert_allclose(execute_plan(plan, a, b).numpy(),
                               torch.einsum("bmk,kn->bmn", a, b).numpy(), atol=1e-5)
