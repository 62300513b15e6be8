"""The port on the card: the CUDA kernel against its plain version, and the
smoke model through the kernel against the same model on the CPU.

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
from repro_torch.kernels.matmul import kernel, matmul, matmul_ref
from repro_torch.models.registry import build_model

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SHAPES = [(128, 128, 128), (256, 384, 512), (200, 300, 260), (512, 128, 384),
          (4, 256, 128), (8, 16, 8), (16, 2048, 512), (17, 300, 70), (1, 7, 3)]


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
