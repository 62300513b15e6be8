"""Rotary position embeddings (llama convention: rotate half), plain or
with YaRN's frequencies as DeepSeek-V2 defines them
(``DeepseekV2YarnRotaryEmbedding``, arXiv:2405.04434; YaRN, arXiv:2309.00071).

YaRN keeps the fast frequencies, divides the slow ones by ``factor`` and
ramps linearly between them over the correction range of dimension pairs
that turn between ``beta_fast`` and ``beta_slow`` times over the original
context; cos and sin are scaled by ``mscale(factor, mscale) /
mscale(factor, mscale_all_dim)``, and the attention's softmax scale by
``mscale(factor, mscale_all_dim) ** 2`` (``attention.mla_scale``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.config import Yarn


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _correction_dim(rotations: float, dim: int, theta: float, original: int) -> float:
    return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(theta))


def yarn_correction_range(y: Yarn, dim: int, theta: float) -> Tuple[int, int]:
    """The first and last dimension pair of the ramp, clipped to the pairs."""
    low = math.floor(_correction_dim(y.beta_fast, dim, theta, y.original_max_pos))
    high = math.ceil(_correction_dim(y.beta_slow, dim, theta, y.original_max_pos))
    return max(low, 0), min(high, dim - 1)


def rope_freqs(head_dim: int, theta: float, device=None,
               yarn: Optional[Yarn] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    if yarn is None:
        return 1.0 / (theta ** exps)
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (yarn.factor * theta ** exps)
    low, high = yarn_correction_range(yarn, head_dim, theta)
    idx = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    ramp = ((idx - low) / (high - low if high > low else 0.001)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, yarn: Optional[Yarn] = None) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer (negative allowed:
    left-padding slots).  Rotates pairs (x[..., :D/2], x[..., D/2:])."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device, yarn)                   # (D/2,)
    ang = positions.to(torch.float32)[..., None] * freqs           # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                             # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    if yarn is not None:
        m = yarn_mscale(yarn.factor, yarn.mscale) / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
        cos, sin = cos * m, sin * m
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
