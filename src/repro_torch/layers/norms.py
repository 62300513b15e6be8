"""RMSNorm with fp32 statistics."""
from __future__ import annotations

import torch


def rms_norm_params(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Variance in fp32, scaling applied in the input dtype (as the
    reference, which avoids fp32 copies of the activation stream)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * weight.to(x.dtype)
