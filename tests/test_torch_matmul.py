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
        assert kernel.default_blocks(4, 2048, 2048, dtype) == blocks[1]
        assert kernel.default_blocks(256, 2048, 2048, dtype) == blocks[0]


@pytest.mark.parametrize("case", [
    "dtype_mismatch", "float16", "three_d", "k_mismatch", "non_contiguous",
    "bad_order", "uncompiled_blocks", "other_device"])
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
    with pytest.raises(ValueError):
        matmul(a, b, **kw)


def test_local_matmul_folds_leading_dims():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, 16), dtype=np.float32)
    w = rng.standard_normal((16, 7), dtype=np.float32)
    out = local_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert out.shape == (2, 3, 5, 7)
    np.testing.assert_allclose(out.numpy(), x @ w, rtol=1e-5, atol=1e-5)
