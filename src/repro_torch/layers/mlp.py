"""SwiGLU MLP (llama family); all three projections go through ``linear``."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import obs
from .linear import linear, linear_params

Params = Dict[str, torch.Tensor]


def mlp_params(generator: torch.Generator, d: int, d_ff: int,
               dtype: torch.dtype, device) -> Params:
    return {
        "w_gate": linear_params(generator, d, d_ff, dtype, device),
        "w_up": linear_params(generator, d, d_ff, dtype, device),
        "w_down": linear_params(generator, d_ff, d, dtype, device),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    # gate/up stay in the compute dtype, as in the reference: silu is tame
    # and fp32 intermediates would double the (B, S, d_ff) traffic
    with obs.span("layer.mlp"):
        g = F.silu(linear(x, p["w_gate"]))
        u = linear(x, p["w_up"])
        return linear(g * u, p["w_down"])
