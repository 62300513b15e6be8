"""The port's Z-order matmul against the JAX package's.

On the CPU the port's ``ops.matmul`` takes the plain version; the JAX
kernel runs as its own tests run it, in Pallas interpret mode.  The CUDA
kernel itself runs only on the card (``tests/test_torch_cuda.py``).  Inputs come from a
seeded numpy generator and reach both packages as the same values (bf16
rounded once, on the JAX side, then carried through float32).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import zorder as jax_zorder
from repro.kernels.matmul import matmul as jax_matmul
from repro_torch.core import zorder
from repro_torch.dist.local import local_matmul
from repro_torch.kernels.matmul import kernel, matmul

SHAPES = [(128, 128, 128), (256, 384, 512), (200, 300, 260), (512, 128, 384),
          (4, 256, 128)]   # the last one is decode-shaped: batch rows x d
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _operands(shape, dtype_name, seed=0):
    """Same values for both packages: (jax a, jax b, torch a, torch b)."""
    m, k, n = shape
    jdt, tdt, _ = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((m, k), dtype=np.float32), jdt)
    b = jnp.asarray(rng.standard_normal((k, n), dtype=np.float32), jdt)
    ta = torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
    tb = torch.from_numpy(np.array(b.astype(jnp.float32))).to(tdt)
    return a, b, ta, tb


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-6)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX kernel's outputs (interpret mode, 128 blocks), per case."""
    out = {}
    for shape in SHAPES:
        for name in DTYPES:
            a, b, _, _ = _operands(shape, name)
            for order in ("zorder", "rowmajor"):
                r = jax_matmul(a, b, block_m=128, block_n=128, block_k=128,
                               order=order, interpret=True)
                out[shape, name, order] = np.asarray(r.astype(jnp.float32))
    return out


@pytest.mark.parametrize("order", ["zorder", "rowmajor"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_matmul_matches_jax_kernel(jax_results, shape, dtype_name, order):
    _, _, ta, tb = _operands(shape, dtype_name)
    out = matmul(ta, tb, order=order)
    assert out.dtype == DTYPES[dtype_name][1] and out.shape == (shape[0], shape[2])
    err = _rel_err(out.float().numpy(), jax_results[shape, dtype_name, order])
    assert err < DTYPES[dtype_name][2], err


@pytest.mark.parametrize("dims", [(gi, gj, gk) for gi in range(1, 6)
                                  for gj in range(1, 6) for gk in (1, 2, 3)]
                         + [(1, 9, 1), (7, 3, 1), (2, 17, 1), (16, 16, 1)])
def test_schedules_match_reference(dims):
    assert zorder.zorder_schedule(*dims) == jax_zorder.zorder_schedule(*dims)
    assert zorder.rowmajor_schedule(*dims) == jax_zorder.rowmajor_schedule(*dims)


def test_morton_helpers_match_reference():
    for code in range(4096):
        ijk = zorder.morton_decode3(code)
        assert ijk == jax_zorder.morton_decode3(code)
        assert zorder.morton_encode3(*ijk) == code
    for n in range(1, 300):
        assert zorder.enclosing_pow2(n) == jax_zorder.enclosing_pow2(n)


@pytest.mark.parametrize("order", ["zorder", "rowmajor"])
def test_tile_table_is_the_schedule(order):
    gm, gn = 3, 5
    table = kernel.tile_table(gm, gn, order, torch.device("cpu")).tolist()
    sched = (jax_zorder.zorder_schedule if order == "zorder"
             else jax_zorder.rowmajor_schedule)(gm, gn, 1)
    assert table == [i for i, _, _ in sched] + [j for _, j, _ in sched]
    assert kernel.tile_table(gm, gn, order, torch.device("cpu")) is \
        kernel.tile_table(gm, gn, order, torch.device("cpu"))   # cached


def test_default_blocks_fit_shared_memory():
    for dtype, blocks in kernel.BLOCKS.items():
        for bm, bn, bk in blocks:
            assert kernel.smem_bytes(bm, bn, bk, dtype) <= kernel.SMEM_LIMIT
    # bf16: the thin route's 16-row tile at decode, the wide route above
    # THIN_MAX_M rows; fp32: the fma route's 16-row and 64-row tiles
    assert kernel.default_blocks(4, 2048, 2048, torch.bfloat16) == (16, 64, 64)
    assert kernel.default_blocks(32768, 2048, 2048, torch.bfloat16) == (128, 256, 64)
    assert kernel.default_blocks(4, 2048, 2048, torch.float32) == (16, 64, 32)
    assert kernel.default_blocks(256, 2048, 2048, torch.float32) == (64, 64, 16)


@pytest.mark.parametrize("blocks", [(dt, b) for dt, bs in kernel.BLOCKS.items() for b in bs],
                         ids=lambda db: f"{str(db[0])[6:]}-{'x'.join(map(str, db[1]))}")
def test_every_compiled_tile_fits_shared_memory(blocks):
    dtype, (bm, bn, bk) = blocks
    assert kernel.smem_bytes(bm, bn, bk, dtype) <= kernel.SMEM_LIMIT
    assert kernel.ROUTE_OF[dtype, (bm, bn, bk)] in kernel.ROUTES


T = kernel.THIN_MAX_M


@pytest.mark.parametrize("m,k,n,dtype,aligned,want", [
    (1, 2048, 512, torch.bfloat16, True, ("thin", (16, 64, 64))),
    (16, 2048, 512, torch.bfloat16, True, ("thin", (16, 64, 64))),
    (17, 2048, 512, torch.bfloat16, True, ("thin", (64, 64, 64))),
    (64, 2048, 8192, torch.bfloat16, True, ("thin", (64, 64, 64))),
    (T, 2048, 512, torch.bfloat16, True, ("thin", (64, 64, 64))),
    (T + 1, 2048, 512, torch.bfloat16, True, ("wide", (128, 128, 64))),
    (256, 2048, 8192, torch.bfloat16, True, ("wide", (128, 128, 64))),
    # the wide tile: 128 x 256 from WIDE_256_MIN_TILES (264) tiles up
    (128 * 33, 2048, 2048, torch.bfloat16, True, ("wide", (128, 256, 64))),
    (128 * 33 - 128, 2048, 2048, torch.bfloat16, True, ("wide", (128, 128, 64))),
    (32768, 3840, 960, torch.bfloat16, True, ("wide", (128, 256, 64))),
    (32768, 10240, 3840, torch.bfloat16, True, ("wide", (128, 256, 64))),
    # operands 16-byte copies and TMA cannot take: the wmma route, by rows
    (16, 300, 264, torch.bfloat16, True, ("wmma", (16, 64, 128))),
    (17, 300, 70, torch.bfloat16, True, ("wmma", (64, 64, 32))),
    (T + 1, 2048, 516, torch.bfloat16, True, ("wmma", (64, 64, 32))),
    (4, 2048, 512, torch.bfloat16, False, ("wmma", (16, 64, 128))),
    (T + 1, 2048, 512, torch.bfloat16, False, ("wmma", (64, 64, 32))),
    (1, 7, 3, torch.bfloat16, True, ("wmma", (16, 64, 128))),
    (4, 0, 8, torch.bfloat16, True, ("wmma", (16, 64, 128))),
    (4, 2048, 512, torch.float32, True, ("fma", (16, 64, 32))),
    (T + 1, 2048, 512, torch.float32, True, ("fma", (64, 64, 16))),
])
def test_route_selection_at_each_threshold(m, k, n, dtype, aligned, want):
    route, blocks = want
    assert kernel.route(m, n, k, dtype, aligned) == route
    assert kernel.default_blocks(m, n, k, dtype, aligned) == blocks
    assert kernel.ROUTE_OF[dtype, blocks] == route


# (k, n) of every product on the two paths, ragged and one-block k, and
# SM counts of an H100 SXM, an H100 PCIe and a single SM
@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("k,n", [(2048, 512), (2048, 2048), (2048, 8192), (8192, 2048),
                                 (3840, 960), (10240, 3840), (72, 40), (64, 8), (8, 8),
                                 (65, 64), (1000, 1024)])
def test_split_plan_covers_k_once_in_order(k, n, sms):
    splits, per = kernel.split_plan(k, n, sms)
    slices = [(s * per * 64, min(k, (s + 1) * per * 64)) for s in range(splits)]
    assert len(slices) == splits and 1 <= splits <= kernel.MAX_SPLITS
    assert slices[0][0] == 0 and slices[-1][1] == k
    for (lo, hi), (lo2, _) in zip(slices, slices[1:]):
        assert hi == lo2                         # consecutive, no gap, no overlap
    assert all(hi > lo for lo, hi in slices)     # none empty
    assert all(lo % 64 == 0 and hi - lo <= per * 64 for lo, hi in slices)
    # the kernel's own slicing: split s takes k blocks [s per, min((s+1) per, nkb))
    nkb = -(-k // 64)
    assert [(min(s * per, nkb), min(s * per + per, nkb)) for s in range(splits)] == \
        [(lo // 64, -(-hi // 64)) for lo, hi in slices]


def test_split_plan_does_not_depend_on_m():
    import inspect
    assert "m" not in inspect.signature(kernel.split_plan).parameters
    # decode's products fill the card: at least about one CTA per SM
    for k, n in [(2048, 512), (2048, 2048), (2048, 8192), (8192, 2048)]:
        splits, _ = kernel.split_plan(k, n, 132)
        assert splits * -(-n // 64) >= 128


@pytest.mark.parametrize("grid", [1, 7, 132, 200])
@pytest.mark.parametrize("gm,gn", [(1, 1), (3, 5), (256, 15), (256, 40)])
def test_persistent_walk_visits_every_tile_once(gm, gn, grid):
    """The wide kernel's loop: ``grid`` persistent CTAs (the wrapper's
    min(SMs, tiles)), CTA c taking table entries c, c + grid, ..."""
    ntiles = gm * gn
    grid = min(grid, ntiles)
    walks = [list(range(c, ntiles, grid)) for c in range(grid)]
    visited = [t for w in walks for t in w]
    assert sorted(visited) == list(range(ntiles))
    table = kernel.tile_table(gm, gn, "zorder", torch.device("cpu")).tolist()
    tiles = {(table[t], table[ntiles + t]) for t in visited}
    assert tiles == {(i, j) for i in range(gm) for j in range(gn)}
    # each CTA takes table entries in Morton order: c, c + grid, ...
    assert all(w == sorted(w) and (not w or w[0] == c) for c, w in enumerate(walks))


@pytest.mark.parametrize("case", [
    "dtype_mismatch", "float16", "three_d", "k_mismatch", "non_contiguous",
    "bad_order", "uncompiled_blocks", "other_device", "thin_blocks_ragged_n",
    "wide_blocks_ragged_k"])
def test_matmul_rejects_what_the_kernel_does_not_take(case):
    a, b = torch.ones(8, 16), torch.ones(16, 8)
    kw = {}
    if case == "dtype_mismatch":
        b = b.bfloat16()
    elif case == "float16":
        a, b = a.half(), b.half()
    elif case == "three_d":
        a = a[None]
    elif case == "k_mismatch":
        b = torch.ones(12, 8)
    elif case == "non_contiguous":
        b = torch.ones(8, 16).t()
    elif case == "bad_order":
        kw["order"] = "hilbert"
    elif case == "uncompiled_blocks":
        kw["block_m"] = 128
    elif case == "other_device":   # never quietly computed elsewhere
        a, b = a.to("meta"), b.to("meta")
    elif case == "thin_blocks_ragged_n":   # the route refuses, never moves on
        a, b = a.bfloat16(), torch.ones(16, 12, dtype=torch.bfloat16)
        kw.update(block_m=16, block_n=64, block_k=64)
    elif case == "wide_blocks_ragged_k":
        a, b = torch.ones(8, 12, dtype=torch.bfloat16), torch.ones(12, 8, dtype=torch.bfloat16)
        kw.update(block_m=128, block_n=256, block_k=64)
    with pytest.raises(ValueError):
        matmul(a, b, **kw)


def test_local_matmul_folds_leading_dims():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, 16), dtype=np.float32)
    w = rng.standard_normal((16, 7), dtype=np.float32)
    out = local_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert out.shape == (2, 3, 5, 7)
    np.testing.assert_allclose(out.numpy(), x @ w, rtol=1e-5, atol=1e-5)


def test_launch_bookkeeping_is_exact_across_threads():
    """The plan engine's rank threads launch K1 concurrently: two threads
    driving the launch counters (the one place launches are counted), the
    tile tables and the split-K counter arrays leave exact counts and one
    shared table and counter array."""
    import sys
    import threading

    kernel.reset_launches()
    per_thread = 20000
    tables, counters = [], []
    cpu = torch.device("cpu")

    def drive(route):
        for i in range(per_thread):
            kernel.count_launch(route, 4, 8, 16)
            if i % 1000 == 0:
                tables.append(kernel.tile_table(7, 5, "zorder", cpu))
                counters.append(kernel.split_counters(cpu, 64))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)      # switch threads as often as possible
    try:
        with kernel.trace_launches() as trace:
            threads = [threading.Thread(target=drive, args=(r,)) for r in ("thin", "wide")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == 2 * per_thread
    assert kernel.launches_by_route == {"wide": per_thread, "thin": per_thread,
                                        "wmma": 0, "fma": 0}
    assert len(trace) == 2 * per_thread and trace[0] == (4, 8, 16, trace[0][3])
    assert all(t is tables[0] for t in tables) and all(c is counters[0] for c in counters)
    kernel.reset_launches()
    assert kernel.launches == 0 and sum(kernel.launches_by_route.values()) == 0
