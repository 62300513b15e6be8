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
