"""Residual blocks.  Ported so far: ``attn_mlp`` (pre-norm GQA attention +
dense SwiGLU, the llama family); the other kinds of ``repro.layers.blocks``
wait for their layers."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from .attention import gqa_attention, gqa_params
from .mlp import mlp, mlp_params
from .norms import rms_norm, rms_norm_params

Params = Dict


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind != "attn_mlp":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"attention {cfg.attn_type!r} is not ported yet")


def block_params(generator: torch.Generator, cfg: ModelConfig, kind: str,
                 dtype: torch.dtype, device) -> Params:
    _check_kind(cfg, kind)
    d = cfg.d_model
    return {
        "attn_norm": rms_norm_params(d, device),
        "attn": gqa_params(generator, cfg, dtype, device),
        "mlp_norm": rms_norm_params(d, device),
        "mlp": mlp_params(generator, d, cfg.d_ff, dtype, device),
    }


def block_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    pos=None,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Returns (x, aux, cache) like the reference; ``aux`` (the MoE load
    loss) is 0 for ``attn_mlp``."""
    _check_kind(cfg, kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, cache = gqa_attention(p["attn"], h, cfg, positions, cache, pos, offsets=offsets)
    x = x + a
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    x = x + mlp(p["mlp"], h)
    return x, aux, cache
