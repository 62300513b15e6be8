"""Parameters from the JAX package's layout into the port's.

The reference keeps a nested dict of arrays with every per-layer parameter
stacked on a leading axis (``params["layers"]["attn"]["wq"]`` is
(L, d, h*hd)).  The port keeps a list of per-layer dicts.  The input here
is that tree with numpy leaves (``jax.tree.map(np.asarray, params)``);
numpy has no bfloat16 of its own, so every leaf crosses through float32
and is cast back to its source type on the torch side.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig

_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """One leaf: float32 or bfloat16 in, the same type out."""
    a = np.asarray(a)
    if a.dtype.name not in _TYPES:
        raise ValueError(f"unsupported parameter type {a.dtype}")
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
    return t.to(device=device, dtype=_TYPES[a.dtype.name])


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return tensor_from_numpy(x, device)


def params_from_jax(np_params: Dict, cfg: ModelConfig,
                    device: DeviceLike = None) -> Dict:
    """The reference ``DecoderLM`` parameter tree -> the port's params."""
    device = resolve_device(device)
    stacked = np_params["layers"]
    n = np.asarray(stacked["attn_norm"]).shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.num_layers}")

    def layer(i, x):
        if isinstance(x, dict):
            return {k: layer(i, v) for k, v in x.items()}
        return tensor_from_numpy(np.asarray(x)[i], device)

    return {
        "embed": _tree(np_params["embed"], device),
        "final_norm": tensor_from_numpy(np_params["final_norm"], device),
        "layers": [layer(i, stacked) for i in range(n)],
    }
