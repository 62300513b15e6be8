"""Plain PyTorch version of flash attention (materialises the score matrix).

Counterpart of ``repro/kernels/flash_attention/ref.py::attention_ref``: fp32
scores and softmax, GQA by repeating the KV heads, masked scores at -inf
and NaN (a row with no valid key) set to 0, so a fully masked row outputs 0.
The score tensor is updated in place where the reference builds new arrays,
so the peak is about two (BH_q, S_q, S_kv) fp32 tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (BH_q, S_q, D); k, v: (BH_kv, S_kv, D) -> (BH_q, S_q, D) in q's type."""
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    group = bhq // bhkv
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float())
    s.mul_(scale)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s.masked_fill_(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    del s
    p.nan_to_num_(nan=0.0)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)
