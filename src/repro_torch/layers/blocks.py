"""Residual blocks, the kinds of ``repro.layers.blocks``: ``attn_mlp``
(pre-norm attention + dense SwiGLU: the llama family, chameleon, minicpm3)
and ``attn_moe`` (pre-norm attention + MoE: qwen3-moe, deepseek-moe), each
with GQA or MLA attention as ``cfg.attn_type`` says; ``mamba`` (pre-norm
Mamba-2, the zamba2 backbone) and ``mlstm`` / ``slstm`` (the xLSTM blocks,
no FFN), each pre-norm + residual.  The encoder-decoder blocks live in
``models/encdec.py``, as in the reference."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from .attention import gqa_attention, gqa_params, mla_attention, mla_params
from .mlp import mlp, mlp_params
from .mamba2 import mamba2, mamba2_params
from .moe import moe, moe_params
from .norms import rms_norm, rms_norm_params
from .xlstm import mlstm, mlstm_params, slstm, slstm_params

Params = Dict

ATTN_KINDS = ("attn_mlp", "attn_moe")
# the recurrent kinds: (params, layer) of the one layer behind the norm
RECURRENT = {"mamba": (mamba2_params, mamba2), "mlstm": (mlstm_params, mlstm),
             "slstm": (slstm_params, slstm)}
KINDS = ATTN_KINDS + tuple(RECURRENT)


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    if kind in ATTN_KINDS and cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(f"attention {cfg.attn_type!r} is not ported yet")


def block_params(generator: torch.Generator, cfg: ModelConfig, kind: str,
                 dtype: torch.dtype, device) -> Params:
    _check_kind(cfg, kind)
    d = cfg.d_model
    if kind in RECURRENT:
        return {"norm": rms_norm_params(d, device),
                kind: RECURRENT[kind][0](generator, cfg, dtype, device)}
    attn = mla_params if cfg.attn_type == "mla" else gqa_params
    p = {"attn_norm": rms_norm_params(d, device),
         "attn": attn(generator, cfg, dtype, device),
         "mlp_norm": rms_norm_params(d, device)}
    if kind == "attn_mlp":
        p["mlp"] = mlp_params(generator, d, cfg.d_ff, dtype, device)
    else:
        p["moe"] = moe_params(generator, cfg, dtype, device)
    return p


def block_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    pos=None,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Returns (x, aux, cache) like the reference; ``aux`` is the MoE
    load-balancing loss, 0 for the other kinds.  The recurrent kinds have
    no positions and ignore ``positions``, ``pos`` and ``offsets``."""
    _check_kind(cfg, kind)
    if kind in RECURRENT:
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        m, cache = RECURRENT[kind][1](p[kind], h, cfg, cache, pos)
        return x + m, torch.zeros((), dtype=torch.float32, device=x.device), cache
    attn = mla_attention if cfg.attn_type == "mla" else gqa_attention
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, cache = attn(p["attn"], h, cfg, positions, cache, pos, offsets=offsets)
    x = x + a
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if kind == "attn_mlp":
        m = mlp(p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        m, aux = moe(p["moe"], h, cfg)
    return x + m, aux, cache
