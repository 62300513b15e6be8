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


# (m, k, n) that the thin and wide routes take in every layout (m, k and
# n multiples of 8): decode's rows, a serving prefill, danube's n = 960
# (ragged tiles), one short k block, split-K with a ragged last block
LAYOUT_SHAPES = [(8, 2048, 1000), (64, 512, 264), (304, 3840, 960), (1000, 72, 136),
                 (48, 1000, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["a", "b", "both"])
@pytest.mark.parametrize("shape", LAYOUT_SHAPES)
def test_transposed_operands_are_read_in_place(cuda_device, shape, which, out_dtype):
    """A ``.t()`` view of A, B or both on the route ``kernel.route`` names
    for the layouts: the same bits as the row-major operands (the same
    tiles, k blocks and products), both tile orders agree, the plain
    version holds it, and the same storage read as row-major operands (on
    the same route, with the same blocks) does not."""
    m, k, n = shape
    a, b = _bf16_operands(cuda_device, m, k, n)
    a_t, b_t = which in ("a", "both"), which in ("b", "both")
    va = a.t().contiguous().t() if a_t else a
    vb = b.t().contiguous().t() if b_t else b
    want = kernel.route(m, n, k, torch.bfloat16, True, a_t, b_t)
    assert want == kernel.route(m, n, k, torch.bfloat16) and want in ("thin", "wide")
    out, got = _route_launches(lambda: matmul(va, vb, out_dtype=out_dtype))
    r = matmul(va, vb, out_dtype=out_dtype, order="rowmajor")
    rowmajor = matmul(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got == {want: 1}
    assert torch.equal(out, r) and torch.equal(out, rowmajor)
    ref = matmul_ref(va, vb, out_dtype)
    assert _row_rel(out, ref) < ROW_TOL_BF16
    blocks = kernel.default_blocks(m, n, k, torch.bfloat16, True, a_t, b_t)
    # the same storage viewed as row-major operands of the same shapes
    wa = va.t().view(m, k) if a_t else va
    wb = vb.t().view(k, n) if b_t else vb
    wrong, moved = _route_launches(lambda: matmul(wa, wb, block_m=blocks[0], block_n=blocks[1],
                                                  block_k=blocks[2], out_dtype=out_dtype))
    torch.cuda.synchronize()
    assert moved == {want: 1}
    assert _row_rel(wrong, ref) > 10 * ROW_TOL_BF16


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
    assert out["cuda"][1] == 7 * cfg.num_layers + 1 and out["cpu"][1] == 0   # + the unembedding
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
    card runs K2 once per layer and K1 seven times and once more for the
    unembedding, the CPU neither."""
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
    assert out["cuda"][1:] == (cfg.num_layers, 7 * cfg.num_layers + 1)
    assert out["cpu"][1:] == (0, 0)
    assert _rel_err(out["cuda"][0], out["cpu"][0]) < 1e-4


# K2's wgmma route, (B, S_q, S_kv, H_q, H_kv, D, causal, window): head dims
# 64, 80, 120 and 128; GQA groups 1 and 4; ragged S_q and S_kv; windows 200
# and 4032; S_q > S_kv with a window, so that the last rows see no key and
# output 0; non-causal with and without a window; a 255-key window, which
# puts tiles' first keys exactly one window before their last rows; then the
# head layouts of granite-20b (48 query heads over one K/V head),
# chameleon-34b (64/8) and qwen3-moe-30b-a3b (32/4), D 128, causal.
WGMMA_SHAPES = [(1, 256, 256, 4, 1, 64, True, 0), (2, 300, 300, 4, 4, 80, True, 0),
                (1, 520, 700, 8, 2, 120, True, 200), (1, 4500, 4500, 4, 1, 128, True, 4032),
                (1, 700, 300, 4, 1, 120, True, 64), (2, 200, 333, 2, 2, 64, False, 0),
                (1, 1000, 1024, 4, 4, 120, False, 100), (1, 4200, 4200, 4, 1, 120, True, 4032),
                (1, 1000, 1000, 4, 1, 120, True, 255),
                (1, 384, 384, 48, 1, 128, True, 0), (1, 384, 384, 64, 8, 128, True, 0),
                (1, 384, 384, 32, 4, 128, True, 0)]
ROW_TOL_BF16 = 1e-2   # worst output row's relative L2 error (chip_smoke.py's ROW_TOL)
# the autograd node of the registered op ``repro_torch::zorder_matmul``
K1_NODE = "GeneratedBackwardFor_repro_torch_zorder_matmul_defaultBackward"


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


# -- the plan engine on the card: R ranks as threads of this process ------------------

# (mesh sizes, axis names, strategy, overlap, K1 launches per product:
# ranks x block products per rank)
PLAN_CELLS = [((2, 2), ("x", "y"), "cannon", False, 8), ((2, 2), ("x", "y"), "cannon", True, 8),
              ((2, 2), ("x", "y"), "summa", False, 4), ((2, 2), ("x", "y"), "summa", True, 8),
              ((2, 2), ("x", "y"), "ring_ag", None, 16), ((2, 2), ("x", "y"), "ring_rs", None, 4),
              ((2, 2, 2), ("pod", "x", "y"), "cannon25d", True, 16),
              ((2, 2, 2), ("pod", "x", "y"), "pod25d", False, 8),
              ((2, 2, 2), ("tree", "x", "y"), "fattree", None, 16),
              ((2,), ("pod",), "pod25d", None, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("cell", PLAN_CELLS,
                         ids=[f"{c[2]}{'+ov' if c[3] else ''}-{'x'.join(map(str, c[0]))}"
                              for c in PLAN_CELLS])
def test_planned_product_on_the_card_matches_k1(cuda_device, cell, m):
    """Each strategy as per-rank programs on one card: every output row of
    a bf16 product within 1e-2 of K1 alone, every rank's block product on
    the route ``kernel.route`` names for its shape (thin at decode rows,
    wide above), and the launch count of ranks x block products."""
    from repro_torch.dist import Mesh, symmetric_matmul

    sizes, names, strategy, overlap, launches = cell
    k, n = 1024, 768
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(cuda_device,
                                                                             torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32) / 32).to(
        cuda_device, torch.bfloat16)
    mesh = Mesh(sizes, names, device=cuda_device)
    kernel.reset_launches()
    with kernel.trace_launches() as trace:
        out = symmetric_matmul(a, b, mesh=mesh, strategy=strategy, overlap=overlap)
        torch.cuda.synchronize()
    assert kernel.launches == len(trace) == launches
    for (pm, pn, pk, r) in trace:
        assert r == kernel.route(pm, pn, pk, torch.bfloat16)
        assert r == ("thin" if pm <= kernel.THIN_MAX_M else "wide")
    assert _row_rel(out, matmul(a, b)) < ROW_TOL_BF16
    mesh.close()


@pytest.mark.cuda
def test_planned_linear_on_the_card_and_a_failing_rank(cuda_device):
    """``linear`` inside ``planned_matmuls`` runs the plan engine on the
    card by default (a ``Mesh`` built without a device is on CUDA); a rank
    that raises reaches the caller and the mesh runs again afterwards."""
    from repro_torch.dist import Mesh, _collectives
    from repro_torch.layers.linear import linear
    from repro_torch.plan import planned_matmuls

    mesh = Mesh((2, 2))
    assert mesh.device.type == "cuda"
    x = torch.randn(2, 16, 256, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn(256, 512, device=cuda_device) / 16).to(torch.bfloat16)
    kernel.reset_launches()
    with planned_matmuls(mesh):
        y = linear(x, w)
    torch.cuda.synchronize()
    assert kernel.launches > 1 and _row_rel(y, linear(x, w)) < ROW_TOL_BF16

    def body(t):
        if _collectives.axis_index(("x", "y")) == 3:
            raise ArithmeticError("rank 3")
        return _collectives.psum(t, "x")

    with pytest.raises(ArithmeticError, match="rank 3"):
        mesh.run(body, {r: (torch.ones(4, device=cuda_device),) for r in range(4)})
    outs = mesh.run(lambda t: _collectives.psum(t, ("x", "y")),
                    {r: (torch.ones(4, device=cuda_device),) for r in range(4)})
    assert all(o.device.type == "cuda" and o.sum().item() == 16 for o in outs.values())
    mesh.close()


@pytest.mark.cuda
def test_kernels_launch_from_a_fresh_thread(cuda_device):
    """A thread that has made no CUDA call yet (a fresh rank thread of the
    plan engine) launches K1's wide route and K2's wgmma route: both encode
    TMA maps through the driver, which needs the context current there."""
    import threading

    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((512, 256), dtype=np.float32)).to(
        cuda_device, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((256, 384), dtype=np.float32)).to(
        cuda_device, torch.bfloat16)
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 256, 256, 4, 2, 64, seed=3)
    got = {}

    def fresh():
        try:
            got["k1"] = matmul(a, b, out_dtype=torch.float32)
            got["k2"] = k2.mha(q, k, v, causal=True)
            torch.cuda.synchronize()
        except Exception as e:   # reported in the main thread
            got["error"] = e

    t = threading.Thread(target=fresh)
    t.start()
    t.join(120)
    assert not t.is_alive() and "error" not in got, got.get("error")
    assert kernel.route(512, 384, 256, torch.bfloat16) == "wide"
    assert _row_rel(got["k1"], matmul(a, b, out_dtype=torch.float32)) < 1e-6
    assert _row_rel(_heads(got["k2"]), _heads(k2.mha(q, k, v, causal=True))) < 1e-6


# -- rank streams: split-K counters per stream, fork and join, capture --------------------


@pytest.mark.cuda
def test_thin_launches_on_two_streams_at_once_give_the_serial_bits(cuda_device):
    """The thin route's split-K arrival counters are per stream: products
    with splits > 1 launched on two streams at once give the bits of the
    same products launched one after the other on one stream."""
    m, k, n = 8, 8192, 2048
    assert kernel.split_plan(k, n, kernel.sm_count(cuda_device))[0] > 1
    pairs = [_bf16_operands(cuda_device, m, k, n, seed=i) for i in range(16)]
    serial = [matmul(a, b) for a, b in pairs]
    streams = (torch.cuda.Stream(cuda_device), torch.cuda.Stream(cuda_device))
    here = torch.cuda.current_stream(cuda_device)
    for s in streams:
        s.wait_stream(here)
    at_once = []
    for i, (a, b) in enumerate(pairs):
        with torch.cuda.stream(streams[i % 2]):
            at_once.append(matmul(a, b))
    for s in streams:
        here.wait_stream(s)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(at_once, serial))
    arrays = {kernel.split_counters(cuda_device, 1, s.cuda_stream).data_ptr() for s in streams}
    assert len(arrays) == 2


@pytest.mark.cuda
def test_a_prepared_capture_stream_keeps_its_counters_in_the_graph(cuda_device):
    """``prepare_capture_stream`` gives the capture stream its counter
    array before the capture, so thin launches captured there use it (no
    array made and zeroed inside the graph) and replay the eager bits."""
    a, b = _bf16_operands(cuda_device, 8, 8192, 2048)
    want = matmul(a, b)
    graph = torch.cuda.CUDAGraph()
    capture = torch.cuda.graph(graph)
    kernel.prepare_capture_stream(capture.capture_stream)
    made = kernel.split_counters(cuda_device, 1, capture.capture_stream.cuda_stream)
    torch.cuda.synchronize()
    with capture:
        inside = kernel.split_counters(cuda_device, 1, capture.capture_stream.cuda_stream)
        out = matmul(a, b)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert inside is made and torch.equal(out, want)


@pytest.mark.cuda
def test_mesh_run_on_the_card_runs_each_rank_on_its_streams(cuda_device):
    """Each rank of a CUDA thread mesh runs on a compute stream of its own
    (not the caller's), and ``Mesh.run`` returns outputs the caller reads
    on its own stream without a synchronise: long rank programs (K1
    products, a deferred ppermute, a psum) read back at once equal the
    same programs run after a synchronise."""
    from repro_torch.dist import Mesh, _collectives

    mesh = Mesh((2, 2), ("x", "y"), device=cuda_device)
    a, b = _bf16_operands(cuda_device, 2048, 4096, 4096)

    def body(x):
        y = x
        for _ in range(4):
            y = matmul(y, b)
        moved = _collectives.ppermute_done(
            _collectives.ppermute_start(y, "y", [(0, 1), (1, 0)]))
        return _collectives.psum(moved.float(), "x"), torch.cuda.current_stream().cuda_stream

    args = {r: (a * (r + 1),) for r in range(4)}
    outs = mesh.run(body, args)
    sums = torch.stack([outs[r][0].sum() for r in range(4)]).cpu()   # no synchronise first
    torch.cuda.synchronize()
    again = mesh.run(body, args)
    torch.cuda.synchronize()
    assert torch.equal(sums, torch.stack([again[r][0].sum() for r in range(4)]).cpu())
    own = [outs[r][1] for r in range(4)]
    assert len(set(own)) == 4 and torch.cuda.current_stream(cuda_device).cuda_stream not in own
    assert own == [mesh._streams[r].compute.cuda_stream for r in range(4)]
    mesh.close()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("strategy,overlap", [("cannon", True), ("summa", True),
                                              ("ring_ag", None), ("cannon", False)])
def test_a_planned_product_captured_on_rank_streams_replays_bitwise(cuda_device, strategy,
                                                                    overlap, m):
    """A planned product on a 2x2 CUDA mesh captured in a CUDA graph (its
    rank streams become the graph's branches, forked from the capturing
    stream and joined back) replays the eager run's bits, on new operands
    copied into the captured ones too."""
    from repro_torch.dist import Mesh, symmetric_matmul

    mesh = Mesh((2, 2), ("x", "y"), device=cuda_device)
    a, b = _bf16_operands(cuda_device, m, 1024, 768)

    def run():
        return symmetric_matmul(a, b, mesh=mesh, strategy=strategy, overlap=overlap)

    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    a2, b2 = _bf16_operands(cuda_device, m, 1024, 768, seed=7)
    a.copy_(a2)
    b.copy_(b2)
    graph.replay()
    want = run()
    torch.cuda.synchronize()
    assert torch.equal(out, want) and not torch.equal(out, eager)
    del graph
    mesh.close()


# -- serving buckets captured as CUDA graphs; the tuner on the card -------------------

SERVE_PROMPTS = [[5, 6, 7], [9, 2, 3, 4, 1], [17, 3], [8, 8, 8, 8, 8, 8, 1]]


def _smoke_llama(cuda_device):
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("llama3_2_1b")            # bf16, as served
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    return model, params


def _eager_tokens(server, prompts):
    """``runtime.serve.generate`` on the batch ``server`` routes
    ``prompts`` to, padded as it pads them: the eager path's new tokens
    per request, and the planned products it ran by strategy."""
    from repro_torch.plan.lower_dist import executions_snapshot
    from repro_torch.runtime.serve import batch_requests, generate
    from repro_torch.serve.buckets import route
    from repro_torch.serve.server import DUMMY_TOKEN, PAD_ID

    bucket = route(len(prompts), max(len(p) for p in prompts), server.buckets)
    dummies = [[DUMMY_TOKEN]] * (bucket.batch - len(prompts))
    batch, lens = batch_requests(list(prompts) + dummies, PAD_ID, pad_to=bucket.seq)
    before = executions_snapshot()
    full = generate(server.model, server.params, batch, server.cfg, lens=lens,
                    mesh=server.mesh)
    after = executions_snapshot()
    sp = batch.shape[1]
    tokens = [full[i, sp - int(lens[i]):].tolist()[int(lens[i]):] for i in range(len(prompts))]
    return tokens, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [None, (2, 2)], ids=["unplanned", "2x2"])
def test_captured_buckets_serve_the_eager_tokens_bitwise(cuda_device, mesh):
    """Each bucket's prefill and decode step captured at warmup and
    replayed: the same tokens, bit for bit, as ``runtime.serve.generate``
    on the same bucket-padded batch; replays counted from the captures,
    none from Python."""
    import collections

    from repro_torch.runtime.serve import ServeConfig
    from repro_torch.serve import Server

    model, params = _smoke_llama(cuda_device)
    cfg = ServeConfig(max_new_tokens=6, max_seq=32)
    graphs = Server(model, params, cfg, mesh=mesh, buckets=[(4, 8), (2, 16)])
    report = graphs.warmup()
    assert all(r["graphs"] == 2 and r["capture_s"] > 0 for r in report.values())
    eager_products = collections.Counter()
    for prompts in (SERVE_PROMPTS, SERVE_PROMPTS[:2], [[3] * 12]):
        kernel.reset_launches()
        got = graphs.generate(prompts)
        assert got.graphs and kernel.launches == 0
        want, products = _eager_tokens(graphs, prompts)
        eager_products.update(products)
        assert got.new_tokens == want
    rep = graphs.cache_report()
    replays = sum(s["replays"] for g in rep["graphs"].values() for s in g.values())
    if mesh is None:
        per_forward = 7 * model.cfg.num_layers + 1        # + the unembedding
        assert rep["kernels"]["zorder_matmul"]["replayed"] == replays * per_forward
    else:
        assert graphs.plan_report()["strategies"] == dict(eager_products)
        graphs.mesh.close()


@pytest.mark.cuda
def test_a_capture_that_cannot_succeed_raises(cuda_device, monkeypatch):
    """A step that synchronises the device cannot be captured: warmup
    raises instead of serving that bucket eagerly."""
    from repro_torch.runtime.serve import ServeConfig
    from repro_torch.serve import Server

    model, params = _smoke_llama(cuda_device)
    real = model.decode_step

    def syncing(*args, **kw):
        torch.cuda.synchronize()
        return real(*args, **kw)

    monkeypatch.setattr(model, "decode_step", syncing)
    server = Server(model, params, ServeConfig(max_new_tokens=4, max_seq=32), buckets=[(2, 8)])
    with pytest.raises(RuntimeError):
        server.warmup()
    torch.cuda.synchronize()
    a = torch.ones(8, 64, device=cuda_device, dtype=torch.bfloat16)
    assert torch.equal(matmul(a, a.t().contiguous()), matmul_ref(a, a.t().contiguous()))


@pytest.mark.cuda
def test_tuner_entries_round_trip_through_save_table(cuda_device, tmp_path):
    """``tune_shape``'s contract: an entry is K1's default candidate unless
    the fastest trial beat the default's trial by more than the noise
    margin (and, not held here, a re-timing agreed); its seconds are the
    smaller of the kept candidate's trial and its re-timing, so at most
    that trial and above 0.  The entries survive ``save_table`` /
    ``load_table``, and a tuner on the loaded table searches nothing."""
    from repro_torch.tune import (Tuner, candidate_route, candidate_space, default_candidate,
                                  load_table, save_table, time_candidate)
    from repro_torch.tune.search import NOISE

    tuner = Tuner(reps=2, device=cuda_device)
    e1 = tuner.entry_for(4, 512, 256)
    e2 = tuner.entry_for(200, 256, 512)
    assert tuner.stats["searches"] == 2
    assert (e1.block_m, e1.block_n, e1.block_k, e1.order) in candidate_space(16, 512, 256)
    assert candidate_route((e2.block_m, e2.block_n, e2.block_k, e2.order), "bfloat16") in (
        "wide", "thin", "wmma")
    for e in (e1, e2):
        trial = {t["blocks"] + (t["order"],): t["seconds"]
                 for t in tuner.trials if t["bucket"] == e.bucket}
        kept = (e.block_m, e.block_n, e.block_k, e.order)
        default = default_candidate(*e.bucket, "bfloat16")
        assert default in trial and kept in trial
        if kept != default:
            assert trial[kept] == min(trial.values())
            assert trial[kept] < trial[default] * (1.0 - NOISE)
        assert 0 < e.seconds <= trial[kept]
    table = tuner.table()
    assert table.device_kind == torch.cuda.get_device_name(cuda_device)
    back = load_table(save_table(table, str(tmp_path / "t.json")))
    assert back == table and back.lookup(4, 512, 256, "bfloat16") == e1
    again = Tuner(table=back, device=cuda_device)
    assert again.entry_for(4, 512, 256) == e1 and again.stats["searches"] == 0
    assert time_candidate(16, 512, 256, "bfloat16", (16, 64, 64, "zorder")) > 0


# -- training: K1's autograd node and the trainer on the card ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 512, 264), (2048, 2048, 512), (300, 72, 136)])
def test_k1_backward_matches_plain_version(cuda_device, shape, dtype):
    """dA and dB of the registered op on the card against the plain
    version's products on the same CUDA tensors; bf16 aligned shapes run
    all three products on the wide route."""
    m, k, n = shape
    rng = np.random.default_rng(m)
    a, b, dc = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda_device, dtype)
                for s in ((m, k), (k, n), (m, n)))
    a.requires_grad_(True)
    b.requires_grad_(True)
    kernel.reset_launches()
    out = matmul(a, b)
    assert out.grad_fn.name() == K1_NODE
    out.backward(dc)
    torch.cuda.synchronize()
    routes = {r: v for r, v in kernel.launches_by_route.items() if v}
    if dtype == torch.float32:
        assert routes == {"fma": 3}
    elif k % 8 == 0 and n % 8 == 0 and m % 8 == 0:
        assert routes == {"wide": 3}
    assert kernel.launches == 3
    tol = ROW_TOL_BF16 if dtype == torch.bfloat16 else 1e-4
    assert _row_rel(a.grad, matmul_ref(dc, b.detach().t().contiguous())) < tol
    assert _row_rel(b.grad, matmul_ref(a.detach().t().contiguous(), dc)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_op_under_dots_checkpointing_matches_plain_version(cuda_device, dtype):
    """A block of two products (product, SiLU, product) under
    ``remat="dots"``: its output and the gradients of its input and both
    weights on the card within ``ROW_TOL`` of the same block on the CPU
    (the plain version); 2 K1 launches forward and 4 backward, the
    products' outputs saved, none recomputed."""
    from repro_torch.models.lm import remat

    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), remat="dots")
    rng = np.random.default_rng(7)
    x, w1, w2, dy = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32) / s[0] ** 0.5)
                     for s in ((512, 256), (256, 264), (264, 128), (512, 128)))

    def block(x, w1, w2):
        return matmul(torch.nn.functional.silu(matmul(x, w1)), w2)

    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        args = [t.to(dev, dtype).requires_grad_(True) for t in (x, w1, w2)]
        kernel.reset_launches()
        y = remat(block, cfg)(*args)
        forward = kernel.launches
        y.backward(dy.to(dev, dtype))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (forward, kernel.launches) == (2, 6)
        out[dev.type] = [y.detach().cpu()] + [a.grad.cpu() for a in args]
    tol = ROW_TOL_BF16 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(out["cuda"], out["cpu"]):
        assert _row_rel(got, want) < tol


@pytest.mark.cuda
def test_smoke_train_step_on_card_matches_cpu(cuda_device):
    """One fp32 step of the smoke Llama: the loss and every master leaf's
    gradient on the card within 1e-4 relative L2 of the CPU's, every
    projection's gradient non-zero, 3 x 7 K1 launches a layer and 3 for
    the unembedding (fp32: its dA and dB through K1 too)."""
    from repro_torch.data.pipeline import DataConfig, device_put_batch, synth_batch
    from repro_torch.runtime.train import TrainConfig, Trainer
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), dtype="float32")
    model = build_model(cfg)
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2), 0)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        master = tree_map(lambda t: t.to(dev, copy=True), params)
        kernel.reset_launches()
        loss, _, grads = Trainer(model, TrainConfig(), device=dev).loss_and_grads(
            master, device_put_batch(batch, dev))
        torch.cuda.synchronize()
        out[dev.type] = (loss.cpu(), [g.cpu() for g in grads], kernel.launches)
    assert out["cuda"][2] == 3 * (7 * cfg.num_layers + 1) and out["cpu"][2] == 0
    assert _rel_err(out["cuda"][0], out["cpu"][0]) < 1e-4
    for g, c in zip(out["cuda"][1], out["cpu"][1]):
        assert c.norm() > 0
        assert ((g - c).norm() / c.norm()).item() < 1e-4


@pytest.mark.cuda
def test_trainer_restarts_on_the_card(cuda_device, tmp_path):
    """The captured step through a failure at step 13: the checkpoint of
    step 8 restored into the donated state, the one graph kept (steps 1-12
    and 8-23 replay it: 28 replays)."""
    from repro_torch.data.pipeline import DataConfig, batch_iterator
    from repro_torch.runtime.train import TrainConfig, Trainer

    cfg = get_smoke_config("llama3_2_1b")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tc = TrainConfig(steps=24, lr=1e-3, warmup=4, ckpt_dir=str(tmp_path), ckpt_every=8,
                     log_every=8, fail_at_step=13)
    trainer = Trainer(build_model(cfg), tc, device=cuda_device)
    out = trainer.fit(torch.Generator(device=cuda_device).manual_seed(0), batch_iterator(dc))
    assert out["restarts"] == 1
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert out["state"]["master"]["embed"]["embedding"].device.type == "cuda"
    report = trainer.graph_report()
    assert trainer.capture and report["captures"] == 1 and report["replays"] == 28
    assert report["k1_replayed"] == {r: 28 * n for r, n in report["k1_per_replay"].items()}
    assert sum(report["k1_per_replay"].values()) == 3 * (7 * cfg.num_layers + 1) - 2


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [None, (2, 2)], ids=["unplanned", "2x2"])
def test_captured_training_steps_follow_the_eager_ones(cuda_device, mesh):
    """The fp32 smoke Llama from one seed and one batch stream, 3 steps
    captured (an eager step, the capture, a replay... of one graph) and 3
    eager: losses within 1e-5 relative, every master within 1e-5 relative
    L2, the learning rate of every step bitwise; on the 2x2 mesh the planned
    products (both sides of the backward) in the graph."""
    from repro_torch.data.pipeline import DataConfig, batch_iterator, device_put_batch
    from repro_torch.dist.mesh import Mesh
    from repro_torch.runtime.sharding import unplace_tree
    from repro_torch.runtime.train import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), dtype="float32")
    runs = {}
    for capture in (True, False):
        m = None if mesh is None else Mesh(mesh, ("data", "model"), device=cuda_device)
        trainer = Trainer(build_model(cfg), TrainConfig(steps=3, lr=1e-3, warmup=1), mesh=m,
                          device=cuda_device, capture=capture)
        state = trainer.init_state(torch.Generator(device=cuda_device).manual_seed(0))
        step = trainer.static_step(state)
        data = batch_iterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))
        losses, lrs = [], []
        for _ in range(3):
            out = step(device_put_batch(next(data), cuda_device, m))
            losses.append(out["loss"].item())
            lrs.append(out["lr"].item())
        torch.cuda.synchronize()
        runs[capture] = ([t.cpu() for t in tree_leaves(unplace_tree(state)["master"])],
                         losses, lrs, trainer.graph_report())
        if m is not None:
            m.close()
    (w1, l1, r1, g1), (w0, l0, r0, g0) = runs[True], runs[False]
    assert g1["captures"] == 1 and g1["replays"] == 2 and g0["captures"] == 0
    assert (sum(g1["products_per_replay"].values()) > 0) == (mesh is not None)
    assert r1 == r0
    for a, b in zip(l1, l0):
        assert abs(a - b) <= 1e-5 * abs(b)
    for a, b in zip(w1, w0):
        assert ((a - b).norm() / b.norm().clamp_min(1e-30)).item() < 1e-5


# -- the MoE and MLA decoders on the card -------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-30b-a3b", "minicpm3-4b"])
def test_zoo_smoke_model_on_card_matches_cpu(cuda_device, arch):
    """fp32 smoke model, the same weights on both devices: prefill and one
    decode step through K1 on the card, the plain version on the CPU;
    logits within 1e-4.  K1 takes 4 attention products a layer (q, k, v, o;
    MLA's cached wq_a, wq_b, wkv_a, wo) and 3 more for a dense MLP or
    shared experts (qwen3's MoE layers have none), and the unembedding's
    one a forward."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0), "cpu")
    params = _to_device(cpu_params, cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(1, 256, size=(2, 8)))
    offsets = torch.tensor([0, 3])
    out = {}
    for dev, p in ((cuda_device, params), (torch.device("cpu"), cpu_params)):
        cache = model.init_cache(2, 16, dev)
        before = kernel.launches
        with torch.no_grad():
            pre, _ = model.prefill(p, cache, tokens.to(dev), offsets.to(dev))
            dec, _ = model.decode_step(p, cache, tokens[:, -1:].to(dev),
                                       torch.tensor(8, device=dev), offsets.to(dev))
        out[dev.type] = (pre.cpu(), dec.cpu(), kernel.launches - before)
    per_layer = 4 + 3 * bool(cfg.num_shared_experts or not cfg.num_experts)
    nd = cfg.first_dense_layers
    per_forward = 7 * nd + per_layer * (cfg.num_layers - nd) + 1
    assert out["cuda"][2] == 2 * per_forward and out["cpu"][2] == 0
    for i in (0, 1):
        assert _rel_err(out["cuda"][i][:, :256], out["cpu"][i][:, :256]) < 1e-4


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device, copy=True)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b"])
def test_captured_moe_and_mla_steps_serve_the_eager_tokens_bitwise(cuda_device, arch):
    """The bf16 smoke deepseek (a dense layer, then MoE) and minicpm3 (MLA)
    behind ``Server``: each bucket's prefill and decode step captured (the
    MoE routing and the latent cache write included) and replayed give the
    eager path's tokens bit for bit, and one captured decode step's logits
    equal an eager step's on the same cache."""
    from repro_torch.runtime.serve import ServeConfig
    from repro_torch.serve import Server

    model = build_model(get_smoke_config(arch))
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    server = Server(model, params, ServeConfig(max_new_tokens=6, max_seq=32),
                    buckets=[(4, 8), (2, 16)])
    report = server.warmup()
    assert all(r["graphs"] == 2 for r in report.values())
    for prompts in (SERVE_PROMPTS, SERVE_PROMPTS[:2], [[3] * 12]):
        kernel.reset_launches()
        got = server.generate(prompts)
        assert got.graphs and kernel.launches == 0
        assert got.new_tokens == _eager_tokens(server, prompts)[0]
    rep = server.cache_report()
    replays = sum(s["replays"] for g in rep["graphs"].values() for s in g.values())
    assert rep["kernels"]["zorder_matmul"]["replayed"] == replays * (7 * model.cfg.num_layers
                                                                     + 1)
    # one decode step: captured against eager, on copies of the same cache
    g = server._captured[next(iter(server._captured))]
    cache = _to_device(g.cache, cuda_device)         # a copy of the bucket's cache
    g.cur.fill_(5)
    g.pos.fill_(g.tokens.shape[1])
    with torch.no_grad():
        eager, _ = model.decode_step(params, cache, g.cur.clone(), g.pos.clone(),
                                     g.offsets.clone())
    captured = server._replay_step(g.steps["decode"])
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


# -- the recurrent and encoder-decoder families on the card ---------------------------

NEW_FAMILIES = ["zamba2-2.7b", "xlstm-350m", "seamless-m4t-medium"]


def _k1_per_step(cfg) -> int:
    """K1 launches of one decode step of a smoke model: zamba2 2 a Mamba
    layer (in_proj, out_proj) and 8 a shared block (shared_in, q, k, v, o,
    gate, up, down); xlstm 4 an mLSTM block, 1 an sLSTM block; seamless 9
    a decoder layer (self q, k, v, o; cross q, o over the cached K/V; the
    MLP's 3); the unembedding's one in each."""
    if cfg.family == "hybrid":
        return 2 * cfg.num_layers + 8 * (cfg.num_layers // cfg.shared_attn_every) + 1
    if cfg.family == "ssm":
        n_m = sum(1 for b in cfg.block_pattern if b == "mlstm")
        groups = cfg.num_layers // len(cfg.block_pattern)
        return groups * (4 * n_m + (len(cfg.block_pattern) - n_m)) + 1
    return 9 * cfg.dec_layers + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_family_smoke_model_on_card_matches_cpu(cuda_device, arch):
    """fp32 smoke model, the same weights on both devices: the uncached
    forward (seamless: encode + decode_train) and a teacher-forced prefill
    of 8 tokens + one decode step (seamless after ``prefill_cross``); the
    card through K1, the CPU through the plain version; logits within
    1e-4."""
    from repro_torch.runtime.serve import prefill

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0), "cpu")
    params = _to_device(cpu_params, cuda_device)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, 256, size=(2, 8)))
    src = torch.from_numpy(rng.standard_normal((2, 32, cfg.d_model), dtype=np.float32))
    out = {}
    for dev, p in ((cuda_device, params), (torch.device("cpu"), cpu_params)):
        before = kernel.launches
        with torch.no_grad():
            if cfg.family == "audio":
                fwd, _ = model.forward(p, {"src_embed": src.to(dev), "tokens": tokens.to(dev)})
                cache = model.prefill_cross(p, model.encode(p, src.to(dev)),
                                            model.init_cache(2, 16, dev, src_len=32))
            else:
                fwd, _ = model.forward(p, tokens.to(dev))
                cache = model.init_cache(2, 16, dev)
            pre = prefill(model, p, cache, tokens.to(dev))
            dec, _ = model.decode_step(p, cache, tokens[:, -1:].to(dev),
                                       torch.tensor(8, device=dev))
        out[dev.type] = (fwd.cpu(), pre.cpu(), dec.cpu(), kernel.launches - before)
    assert out["cpu"][3] == 0 and out["cuda"][3] > 9 * _k1_per_step(cfg)
    for i in (0, 1, 2):
        assert _rel_err(out["cuda"][i][..., :256], out["cpu"][i][..., :256]) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_captured_recurrent_and_encdec_steps_serve_the_eager_tokens_bitwise(cuda_device, arch):
    """The bf16 smoke models behind ``Server``: each bucket's teacher-forced
    prefill (S decode steps in one graph) and decode step captured and
    replayed give the eager path's tokens bit for bit; the replays launch
    the captured K1 count, S + new - 1 steps a request."""
    from repro_torch.runtime.serve import ServeConfig
    from repro_torch.serve import Server

    model = build_model(get_smoke_config(arch))
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    server = Server(model, params, ServeConfig(max_new_tokens=6, max_seq=32),
                    buckets=[(4, 8), (2, 16)])
    report = server.warmup()
    assert all(r["graphs"] == 2 for r in report.values())
    for prompts in (SERVE_PROMPTS, SERVE_PROMPTS[:2], [[3] * 12]):
        kernel.reset_launches()
        got = server.generate(prompts)
        assert got.graphs and kernel.launches == 0
        assert got.new_tokens == _eager_tokens(server, prompts)[0]
    per_step = _k1_per_step(model.cfg)
    for label, g in server.cache_report()["graphs"].items():
        seq = int(label.split("x")[1])
        assert sum(g["prefill"]["k1_per_replay"].values()) == seq * per_step
        assert sum(g["decode"]["k1_per_replay"].values()) == per_step


# K2 at the new families' full widths: zamba2's shared block (32 heads of 80,
# causal; the forward of chip_smoke phase 16d at 4096 of its 8192 tokens)
# and seamless's encoder (16 heads of 64, non-causal, 4 x 1024 frames)
NEW_FAMILY_K2 = [(1, 4096, 4096, 32, 32, 80, True, 0), (4, 1024, 1024, 16, 16, 64, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", NEW_FAMILY_K2, ids=["zamba2-shared", "seamless-encoder"])
def test_k2_at_the_new_families_shapes(cuda_device, shape):
    b, sq, skv, hq, hkv, d, causal, window = shape
    q, k, v = _qkv(cuda_device, torch.bfloat16, b, sq, skv, hq, hkv, d, seed=d)
    k2.kernel.reset_launches()
    out = k2.mha(q, k, v, causal=causal, window=window)
    again = k2.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k2.kernel.launches_by_route == {"wgmma": 2, "mma": 0, "fma": 0}
    assert torch.equal(out, again)
    ref = k2.attention_ref(_heads(q), _heads(k), _heads(v), causal=causal, window=window)
    assert _row_rel(_heads(out), ref) < ROW_TOL_BF16


# -- sharded training on the card ---------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strategy", ["summa", "ring_rs", "cannon"])
def test_planned_gradients_on_the_card_match_mesh_none(cuda_device, strategy, dtype):
    """One planned product's dA and dB on a 2x2 mesh of rank threads on the
    card against K1's own backward without a mesh (fp32 1e-4, bf16 1e-2 per
    row); the backward's products launch K1 in the rank threads."""
    from repro_torch.dist import Mesh, symmetric_matmul

    rng = np.random.default_rng(2)
    a0 = torch.from_numpy(rng.standard_normal((2, 96, 256), dtype=np.float32))
    b0 = torch.from_numpy(rng.standard_normal((256, 192), dtype=np.float32) / 16)
    r = torch.from_numpy(rng.standard_normal((2, 96, 192), dtype=np.float32)).to(
        cuda_device, dtype)
    mesh = Mesh((2, 2), ("x", "y"), device=cuda_device)
    out = {}
    for planned in (False, True):
        a = a0.to(cuda_device, dtype).requires_grad_(True)
        b = b0.to(cuda_device, dtype).requires_grad_(True)
        c = symmetric_matmul(a, b, mesh=mesh, strategy=strategy) if planned else \
            matmul(a.reshape(-1, 256), b).reshape(2, 96, 192)
        kernel.reset_launches()
        out[planned] = torch.autograd.grad(c, (a, b), r)
        torch.cuda.synchronize()
        out[planned, "launches"] = kernel.launches
    assert out[False, "launches"] == 2 and out[True, "launches"] > 2 * 4 - 1
    tol = ROW_TOL_BF16 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(out[True], out[False]):
        assert got.dtype == dtype and got.device.type == "cuda"
        assert _row_rel(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])) < tol
    mesh.close()


@pytest.mark.cuda
def test_a_planned_backward_on_autograds_device_thread_still_plans(cuda_device):
    """On the card autograd runs the backward on a device thread of its own,
    where the plan scope's ``ContextVar`` is unset: the planned products'
    backward and a ``remat="dots"`` recompute still plan there (zamba2's
    smoke model on 2x2: forward + recompute of the Mamba projections + dA +
    dB), and no K1 product runs outside the rank threads."""
    import importlib
    import threading

    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.dist import Mesh
    from repro_torch.kernels.matmul import ops
    from repro_torch.plan import planned_matmuls
    from repro_torch.tree import tree_leaves, tree_map

    lower_dist = importlib.import_module("repro_torch.plan.lower_dist")
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"), dtype="float32", remat="dots")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), cuda_device)
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    nb = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2), 0)
    batch = {k: torch.from_numpy(v).long().to(cuda_device) for k, v in nb.items()}
    mesh = Mesh((2, 2), ("data", "model"), device=cuda_device)
    threads = {"backward": set(), "k1_outside_ranks": 0}
    real = ops._run

    def run(*args):
        if not threading.current_thread().name.startswith("mesh-rank"):
            threads["k1_outside_ranks"] += 1
        return real(*args)

    ops._run = run
    try:
        lower_dist.reset_executions()
        with planned_matmuls(mesh):
            loss, _ = model.loss(params, batch)
        forward = sum(lower_dist.executions.values())
        loss.register_hook(lambda g: threads["backward"].add(threading.current_thread()))
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
    finally:
        ops._run = real
    total = sum(lower_dist.executions.values())
    assert threads["backward"] and threading.main_thread() not in threads["backward"]
    assert total == 3 * forward + 2 * cfg.num_layers, (forward, total)
    # the unembedding's product, dA and dB (fp32): never planned
    assert threads["k1_outside_ranks"] == 3
    want = torch.autograd.grad(model.loss(tree_map(lambda t: t, params), batch)[0], leaves)
    for g, w in zip(grads, want):
        assert ((g - w).norm() / (w.norm() + 1e-30)).item() < 1e-4
    mesh.close()


# -- K2 as a dispatcher op; the cost counter on fake CUDA tensors --------------------------


def _k2_raw(q, k, v, causal, window):
    """K2's launch as it was before it became an op: the wrapper alone."""
    return k2.flash_attention_bshd(q, k, v, causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 300, 300, 8, 4, 64, True, 0), (1, 512, 512, 4, 2, 120, True, 128),
                                  (2, 256, 256, 4, 4, 64, False, 0), (1, 200, 200, 2, 1, 80, True, 0)])
def test_k2_op_is_bitwise_the_wrappers_launch_eager_and_captured(cuda_device, case):
    b, sq, skv, hq, hkv, d, causal, window = case
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            cuda_device, torch.bfloat16)

    q, kk, v = t(b, sq, hq, d), t(b, skv, hkv, d), t(b, skv, hkv, d)
    with torch.no_grad():
        want = _k2_raw(q, kk, v, causal, window)
        k2.kernel.reset_launches()
        got = k2.mha(q, kk, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert k2.kernel.launches == 1
        assert torch.equal(got, want)
        graph = torch.cuda.CUDAGraph()
        static = k2.mha(q, kk, v, causal=causal, window=window)   # warm outside capture
        with torch.cuda.graph(graph):
            static = k2.mha(q, kk, v, causal=causal, window=window)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(static, want)


def _smoke_decode_cost(device, arch="llama3.2-1b"):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.specs import abstract_params
    from repro_torch.roofline import hlo_stats
    from repro_torch.runtime.serve import decode_step

    cfg = get_smoke_config(arch)
    with FakeTensorMode():
        model, params = abstract_params(cfg, device)
        cache = model.init_cache(2, 16, device)
        tokens = torch.empty((2, 1), dtype=torch.int64, device=device)
        with hlo_stats.counting() as c, torch.no_grad():
            decode_step(model, params, cache, tokens, 3)
    return c


def _smoke_train_cost(device, arch="llama3.2-1b", mesh=None):
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.roofline import hlo_stats

    counter = hlo_stats.Counter()
    rec = lower_cell(arch, ShapeCell("train_4k", 32, 4, "train"), mesh,
                     cfg=get_smoke_config(arch), device=device, counter=counter)
    return counter, rec


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_fake_cuda_and_fake_cpu_count_the_same_cost(cuda_device, arch):
    from repro_torch.dist.mesh import Mesh

    for count in (_smoke_decode_cost, _smoke_train_cost):
        got = count(cuda_device, arch)
        want = count(torch.device("cpu"), arch)
        if isinstance(got, tuple):
            (got, rec_gpu), (want, rec_cpu) = got, want
            assert rec_gpu["memory"] == rec_cpu["memory"]
        assert got.costs == want.costs and got.by_op == want.by_op
    # the backward on autograd's device thread and the rank threads count as on the CPU
    got = _smoke_train_cost(cuda_device, arch, Mesh((2, 2), ("data", "model"), device=cuda_device))
    want = _smoke_train_cost(torch.device("cpu"), arch, Mesh((2, 2), ("data", "model"), device="cpu"))
    assert got[1]["counted"] == want[1]["counted"] and got[1]["roofline"] == want[1]["roofline"]


@pytest.mark.cuda
def test_a_fake_trace_leaves_the_launch_counters_unchanged(cuda_device):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.specs import abstract_params

    kernel.reset_launches()
    k2.kernel.reset_launches()
    before = (dict(kernel.launches_by_route), dict(k2.kernel.launches_by_route))
    counter = _smoke_decode_cost(cuda_device)
    _smoke_train_cost(cuda_device)
    cfg = dataclasses.replace(get_smoke_config("h2o-danube-3-4b"), attn_impl="flash")
    with FakeTensorMode(), torch.no_grad():
        model, params = abstract_params(cfg, cuda_device)
        model.forward(params, torch.empty((1, 64), dtype=torch.int64, device=cuda_device))
    assert counter.calls["repro_torch::zorder_matmul"] > 0
    assert (kernel.launches, k2.kernel.launches) == (0, 0)
    assert (dict(kernel.launches_by_route), dict(k2.kernel.launches_by_route)) == before


# The reference demo's collective bytes per device (``examples/distributed_matmul.py``
# on 16 fake CPU devices, where XLA makes every bf16 collective an f32 one)
DEMO_F32_BYTES = {"cannon": {"collective-permute": 524288}, "summa": {"all-gather": 524288},
                  "summa+ov": {"collective-permute": 393216},
                  "pod25d": {"all-reduce": 262144, "collective-permute": 262144},
                  "ring_ag": {"collective-permute": 458752}}


@pytest.mark.cuda
def test_distributed_demo_on_the_card(cuda_device):
    """``repro_torch.examples.distributed_matmul`` on the card: in fp32 each
    strategy counts the reference demo's bytes by kind; in bf16 the bf16
    blocks are half of them (the 2.5D all-reduce sums fp32 partials), each
    row within 2^-8 of the fp32 product; every block product a K1 launch."""
    from repro_torch.examples import distributed_matmul

    runs = {dt: distributed_matmul.main(["--dtype", dt]) for dt in ("float32", "bfloat16")}
    for name, want in DEMO_F32_BYTES.items():
        f32, bf16 = runs["float32"]["strategies"][name], runs["bfloat16"]["strategies"][name]
        assert f32["by_kind"] == want and f32["same_on_every_rank"]
        assert bf16["by_kind"] == {k: v if k == "all-reduce" else v // 2 for k, v in want.items()}
        assert f32["ranks"] == bf16["ranks"] == (8 if name in ("pod25d", "ring_ag") else 16)
        assert set(f32["k1_routes"]) == {"fma"} and set(bf16["k1_routes"]) <= {"wide", "thin"}
        out, ref = bf16["out"].float(), bf16["ref"]
        assert ((out - ref).norm(dim=1) / ref.norm(dim=1)).max().item() <= 2.0 ** -8
        assert _rel_err(f32["out"], f32["ref"]) < TOL[torch.float32]
