"""The port on the card: the CUDA kernels (K1, the Z-order matmul; K2, flash
attention) against their plain versions, and the smoke models through the
kernels against the same models on the CPU.

Every test here needs an NVIDIA card (``cuda`` marker) and skips where
``torch.cuda.is_available()`` is false.  The file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels.matmul import kernel, matmul, matmul_ref
from repro_torch.models.registry import build_model

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
T = kernel.THIN_MAX_M
# Both sides of each route threshold (m = 16 | 17 and THIN_MAX_M | + 1),
# danube's n = 960 and K = 10240, ragged m, n and k for the wmma route
SHAPES = [(128, 128, 128), (256, 384, 512), (200, 300, 260), (512, 128, 384),
          (4, 256, 128), (8, 16, 8), (16, 2048, 512), (17, 300, 70), (1, 7, 3),
          (17, 2048, 512), (T, 512, 264), (T + 1, 512, 264), (64, 10240, 960),
          (300, 10240, 960), (129, 3840, 960), (1000, 72, 136)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain fp32 reference
    return torch.device("cuda")


def _rel_err(out, ref):
    out, ref = out.double(), ref.double()
    return ((out - ref).abs().max() / (ref.abs().max() + 1e-12)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(cuda_device, shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(cuda_device, dtype)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(cuda_device, dtype)
    before = kernel.launches
    z = matmul(a, b, order="zorder")
    r = matmul(a, b, order="rowmajor")
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(z, r)        # same per-tile k order: bitwise equal
    assert _rel_err(z, matmul_ref(a, b)) < TOL[dtype]


def _bf16_operands(device, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(device, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k))
    return a, b.to(device, torch.bfloat16)


def _route_launches(fn):
    before = dict(kernel.launches_by_route)
    out = fn()
    return out, {r: v - before[r] for r, v in kernel.launches_by_route.items() if v != before[r]}


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [s for s in SHAPES])
def test_each_route_runs_its_shapes_bitwise_repeatably(cuda_device, shape, out_dtype):
    """Each bf16 shape launches the route ``kernel.route`` names for it, is
    held to the plain version, and gives the same bits in both tile orders
    and in a second launch (the thin route's split-K sums in a fixed order)."""
    m, k, n = shape
    a, b = _bf16_operands(cuda_device, m, k, n)
    z, got = _route_launches(lambda: matmul(a, b, out_dtype=out_dtype))
    r = matmul(a, b, out_dtype=out_dtype, order="rowmajor")
    again = matmul(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got == {kernel.route(m, n, k, torch.bfloat16): 1}
    assert torch.equal(z, r) and torch.equal(z, again)
    assert _rel_err(z, matmul_ref(a, b, out_dtype)) < TOL[torch.bfloat16]


@pytest.mark.cuda
def test_unaligned_base_takes_the_wmma_route(cuda_device):
    m, k, n = 64, 2048, 512
    a, b = _bf16_operands(cuda_device, m, k, n)
    flat = torch.empty(m * k + 1, dtype=torch.bfloat16, device=cuda_device)
    shifted = flat[1:].view(m, k)                # contiguous, base 2 bytes off
    shifted.copy_(a)
    assert shifted.data_ptr() % 16 != 0
    out, got = _route_launches(lambda: matmul(shifted, b))
    torch.cuda.synchronize()
    assert got == {"wmma": 1}
    assert _rel_err(out, matmul_ref(a, b)) < TOL[torch.bfloat16]
    with pytest.raises(ValueError, match="16-byte aligned"):
        matmul(shifted, b, block_m=64, block_n=64, block_k=64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 8192, 2048), (64, 2048, 512), (300, 3840, 960)],
                         ids=["thin16", "thin64", "wide"])
def test_route_in_a_cuda_graph_matches_eager(cuda_device, shape):
    """One product of each new route captured in a CUDA graph and replayed
    twice gives the eager bits: no host sync or allocation in the launch."""
    m, k, n = shape
    a, b = _bf16_operands(cuda_device, m, k, n)
    eager = matmul(a, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = matmul(a, b)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_kernel_output_types(cuda_device):
    a = torch.ones(5, 9, device=cuda_device, dtype=torch.bfloat16)
    b = torch.ones(9, 6, device=cuda_device, dtype=torch.bfloat16)
    out = matmul(a, b, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and torch.all(out == 9)


@pytest.mark.cuda
def test_smoke_model_on_card_matches_cpu(cuda_device):
    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cuda_device)
    cpu_params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(1, 256, size=(2, 8)))
    offsets = torch.tensor([0, 3])
    out = {}
    for dev, p in ((cuda_device, params), (torch.device("cpu"), cpu_params)):
        cache = model.init_cache(2, 16, dev)
        before = kernel.launches
        logits, _ = model.prefill(p, cache, tokens.to(dev), offsets.to(dev))
        out[dev.type] = (logits.cpu(), kernel.launches - before)
    assert out["cuda"][1] == 7 * cfg.num_layers and out["cpu"][1] == 0
    assert _rel_err(out["cuda"][0][:, :256], out["cpu"][0][:, :256]) < 1e-4


# (B, S_q, S_kv, H_q, H_kv, D, causal, window): GQA, windows, ragged lengths,
# head dims padded to 32, 64 and 128 inside the kernel, rows with no key
FLASH_SHAPES = [(2, 256, 256, 4, 2, 32, True, 0), (1, 384, 384, 2, 2, 32, True, 200),
                (2, 300, 512, 4, 2, 120, True, 0), (2, 200, 200, 4, 1, 16, True, 64),
                (1, 130, 70, 8, 8, 64, False, 0), (1, 100, 40, 2, 1, 80, True, 8),
                (3, 65, 65, 2, 2, 128, False, 30), (1, 70, 90, 2, 1, 24, True, 0)]


def _qkv(device, dtype, b, sq, skv, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device, dtype)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


def _heads(x):  # (B, S, H, D) -> (B*H, S, D)
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain_version(cuda_device, shape, dtype):
    b, sq, skv, hq, hkv, d, causal, window = shape
    q, k, v = _qkv(cuda_device, dtype, b, sq, skv, hq, hkv, d)
    before = k2.kernel.launches
    out = k2.mha(q, k, v, causal=causal, window=window)
    heads = k2.flash_attention(_heads(q), _heads(k), _heads(v), causal=causal,
                               window=window)
    torch.cuda.synchronize()
    assert k2.kernel.launches == before + 2
    ref = k2.attention_ref(_heads(q), _heads(k), _heads(v), causal=causal, window=window)
    assert torch.equal(_heads(out), heads)     # the two layouts run the same tiles
    assert _rel_err(heads, ref) < TOL[dtype]


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_do(cuda_device):
    q, k, v = _qkv(cuda_device, torch.float32, 1, 8, 8, 2, 1, 16)
    with pytest.raises(NotImplementedError, match="backward"):
        k2.mha(q.requires_grad_(), k, v)
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 8, 8, 2, 1, 256)
    with pytest.raises(ValueError, match="head dim 256"):
        k2.mha(q, k, v)
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 8, 8, 2, 1, 20)
    with pytest.raises(ValueError, match="16-byte chunks"):
        k2.mha(q, k, v)


@pytest.mark.cuda
def test_danube_smoke_flash_forward_on_card_matches_cpu(cuda_device):
    """The long-prefill slice at smoke size: S = 64 is four windows; the
    card runs K2 once per layer and K1 seven times, the CPU neither."""
    cfg = dataclasses.replace(get_smoke_config("h2o-danube-3-4b"), dtype="float32",
                              attn_impl="flash")
    model = build_model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, size=(2, 64)))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        params = model.init(torch.Generator().manual_seed(0), dev)
        before = (k2.kernel.launches, kernel.launches)
        with torch.no_grad():
            logits, _ = model.forward(params, tokens.to(dev))
        out[dev.type] = (logits.cpu(), k2.kernel.launches - before[0],
                         kernel.launches - before[1])
    assert out["cuda"][1:] == (cfg.num_layers, 7 * cfg.num_layers)
    assert out["cpu"][1:] == (0, 0)
    assert _rel_err(out["cuda"][0], out["cpu"][0]) < 1e-4


# K2's wgmma route, (B, S_q, S_kv, H_q, H_kv, D, causal, window): head dims
# 64, 80, 120 and 128; GQA groups 1 and 4; ragged S_q and S_kv; windows 200
# and 4032; S_q > S_kv with a window, so that the last rows see no key and
# output 0; non-causal with and without a window; a 255-key window, which
# puts tiles' first keys exactly one window before their last rows.
WGMMA_SHAPES = [(1, 256, 256, 4, 1, 64, True, 0), (2, 300, 300, 4, 4, 80, True, 0),
                (1, 520, 700, 8, 2, 120, True, 200), (1, 4500, 4500, 4, 1, 128, True, 4032),
                (1, 700, 300, 4, 1, 120, True, 64), (2, 200, 333, 2, 2, 64, False, 0),
                (1, 1000, 1024, 4, 4, 120, False, 100), (1, 4200, 4200, 4, 1, 120, True, 4032),
                (1, 1000, 1000, 4, 1, 120, True, 255)]
ROW_TOL_BF16 = 1e-2   # worst output row's relative L2 error (chip_smoke.py's ROW_TOL)


def _row_rel(out, ref):
    """The worst row's ||out - ref|| / ||ref||; a row that is 0 in ref must
    be 0 in out (anything else reads about 1e30)."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    return ((o - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_wgmma_route_matches_plain_version_row_by_row(cuda_device, shape):
    b, sq, skv, hq, hkv, d, causal, window = shape
    q, k, v = _qkv(cuda_device, torch.bfloat16, b, sq, skv, hq, hkv, d, seed=sq + d)
    k2.kernel.reset_launches()
    out = k2.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k2.kernel.launches_by_route == {"wgmma": 1, "mma": 0, "fma": 0}
    ref = k2.attention_ref(_heads(q), _heads(k), _heads(v), causal=causal, window=window)
    assert _row_rel(_heads(out), ref) < ROW_TOL_BF16
    if sq > skv + window > window > 0:
        assert not _heads(out)[:, skv + window:].any()   # rows past every key's window


@pytest.mark.cuda
def test_wgmma_route_reads_strided_views(cuda_device):
    """Head slices of one fused (B, S, H_q + 2 H_kv, D) tensor, and the
    reference's (BH, S, D) entry, read in place: the same bits as on
    contiguous copies, within the limit of the plain version."""
    b, s, hq, hkv, d = 2, 384, 8, 2, 120
    rng = np.random.default_rng(7)
    fused = torch.from_numpy(rng.standard_normal((b, s, hq + 2 * hkv, d), dtype=np.float32))
    fused = fused.to(cuda_device, torch.bfloat16)
    q, k, v = fused[:, :, :hq], fused[:, :, hq:hq + hkv], fused[:, :, hq + hkv:]
    k2.kernel.reset_launches()
    sliced = k2.mha(q, k, v, causal=True, window=200)
    dense = k2.mha(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, window=200)
    heads = k2.flash_attention(_heads(q), _heads(k), _heads(v), causal=True, window=200)
    torch.cuda.synchronize()
    assert k2.kernel.launches_by_route["wgmma"] == 3
    assert torch.equal(sliced, dense) and torch.equal(_heads(sliced), heads)
    ref = k2.attention_ref(_heads(q), _heads(k), _heads(v), causal=True, window=200)
    assert _row_rel(heads, ref) < ROW_TOL_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [0, 2], ids=["batch", "head"])
def test_broadcast_kv_runs_on_the_mma_route(cuda_device, dim):
    """K and V expanded over the batch or the KV heads (stride 0), bf16 at
    danube's D = 120: TMA takes no stride of 0, so the call runs on the mma
    route, reading the broadcast in place, within the limit of the plain
    version."""
    b, s, hq, hkv, d = 2, 384, 8, 2, 120
    q, k, v = _qkv(cuda_device, torch.bfloat16, b, s, s, hq, hkv, d, seed=13)
    k, v = (x.narrow(dim, 0, 1).expand(x.shape) for x in (k, v))
    assert k.stride(dim) == 0
    k2.kernel.reset_launches()
    out = k2.mha(q, k, v, causal=True, window=200)
    torch.cuda.synchronize()
    assert k2.kernel.launches_by_route == {"wgmma": 0, "mma": 1, "fma": 0}
    ref = k2.attention_ref(_heads(q), _heads(k), _heads(v), causal=True, window=200)
    assert _row_rel(_heads(out), ref) < ROW_TOL_BF16


@pytest.mark.cuda
def test_wgmma_route_reruns_bitwise_and_runs_in_a_cuda_graph(cuda_device):
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 1000, 1000, 8, 2, 120, seed=3)
    first = k2.mha(q, k, v, causal=True, window=256)
    again = k2.mha(q, k, v, causal=True, window=256)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    k2.kernel.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k2.mha(q, k, v, causal=True, window=256)
    graph.replay()
    torch.cuda.synchronize()
    assert k2.kernel.launches_by_route["wgmma"] == 1
    assert torch.equal(captured, first)


@pytest.mark.cuda
def test_forced_routes(cuda_device):
    """A forced route runs its own kernel or raises; never another one."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 300, 300, 4, 2, 120, seed=5)
    k2.kernel.reset_launches()
    wg = k2.kernel.flash_attention_bshd(q, k, v, window=100, route="wgmma")
    mma = k2.kernel.flash_attention_bshd(q, k, v, window=100, route="mma")
    torch.cuda.synchronize()
    assert k2.kernel.launches_by_route == {"wgmma": 1, "mma": 1, "fma": 0}
    assert k2.kernel.launches == 2
    ref = k2.attention_ref(_heads(q), _heads(k), _heads(v), window=100)
    assert _row_rel(_heads(wg), ref) < ROW_TOL_BF16 and _row_rel(_heads(mma), ref) < ROW_TOL_BF16
    k2.kernel.reset_launches()
    assert k2.kernel.launches == 0 and not any(k2.kernel.launches_by_route.values())
    q32, k32, v32 = _qkv(cuda_device, torch.bfloat16, 1, 64, 64, 2, 1, 32)
    with pytest.raises(ValueError, match="wgmma route takes"):
        k2.kernel.flash_attention_bshd(q32, k32, v32, route="wgmma")
    with pytest.raises(ValueError, match="fma route takes"):
        k2.kernel.flash_attention_bshd(q, k, v, route="fma")
    assert k2.kernel.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.3, -0.2, 0.0])
def test_wgmma_route_takes_any_scale(cuda_device, scale):
    """A positive scale is folded into the exponent's FFMA; a negative or
    zero one is applied to the scores first.  Both match the plain version."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 300, 300, 4, 2, 64, seed=11)
    k2.kernel.reset_launches()
    out = k2.mha(q, k, v, causal=True, window=100, scale=scale)
    torch.cuda.synchronize()
    assert k2.kernel.launches_by_route["wgmma"] == 1
    ref = k2.attention_ref(_heads(q), _heads(k), _heads(v), window=100, scale=scale)
    assert _row_rel(_heads(out), ref) < ROW_TOL_BF16
