"""Rotary position embeddings (llama convention: rotate half)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer (negative allowed:
    left-padding slots).  Rotates pairs (x[..., :D/2], x[..., D/2:])."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                         # (D/2,)
    ang = positions.to(torch.float32)[..., None] * freqs           # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                             # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
