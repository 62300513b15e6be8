"""Parameters and optimizer state between the JAX package's layout and the
port's, both ways.

The reference keeps a nested dict of arrays with every per-layer parameter
stacked on a leading axis (``params["layers"]["attn"]["wq"]`` is
(L, d, h*hd); an MoE layer's expert weights are (L, E, d, ff); deepseek-moe's
leading dense layers are a stack of their own, ``params["dense_layers"]``;
the hybrid's ``mamba_layers``, xLSTM's ``m_layers`` / ``s_layers``, the
encoder-decoder's ``enc_layers`` / ``dec_layers``).  The port keeps a list
of per-layer dicts under the same keys (each model's ``param_stacks()``
names them); every other entry (the embedding, the norms, the hybrid's
``shared_in`` and unstacked ``shared`` block) is the same tree on both
sides.  Into the port,
the input is that tree with numpy leaves (``jax.tree.map(np.asarray,
params)``) or torch tensors (a tree ``checkpoint.store`` restored in that
layout); numpy has no bfloat16 of its own, so every leaf crosses through
float32 and is cast back to its source type on the torch side (exact).
Out of the port, ``params_to_jax`` / ``state_to_jax`` stack the layers
back into torch tensors on the CPU, types kept: ``checkpoint.store``
writes them in the reference's format, bf16 as its bits.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model

_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """One leaf: float32 or bfloat16 in, the same type out."""
    if torch.is_tensor(a):
        if a.dtype not in _TYPES.values():
            raise ValueError(f"unsupported parameter type {a.dtype}")
        return a.detach().to(device, copy=True)
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
    """A reference model's parameter tree (any family) -> the port's params."""
    device = resolve_device(device)

    def layer(i, x):
        if isinstance(x, dict):
            return {k: layer(i, v) for k, v in x.items()}
        return tensor_from_numpy(x[i] if torch.is_tensor(x) else np.asarray(x)[i], device)

    def first_leaf(x):
        return first_leaf(next(iter(x.values()))) if isinstance(x, dict) else x

    stacks = dict(build_model(cfg).param_stacks())
    out = {}
    for key, x in np_params.items():
        if key not in stacks:
            out[key] = _tree(x, device)
            continue
        n = first_leaf(x).shape[0]
        if n != stacks[key]:
            raise ValueError(f"tree has {n} {key}, config {stacks[key]}")
        out[key] = [layer(i, x) for i in range(n)]
    missing = sorted(set(stacks) - set(out))
    if missing:
        raise ValueError(f"tree has no {missing}")
    return out


def _host(x):
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x.detach().cpu()


def params_to_jax(params: Dict) -> Dict:
    """The port's params -> the reference's layout: each per-layer list's
    leaves stacked on a leading layer axis, every other entry as it is;
    torch tensors on the CPU, types kept."""
    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack([x.detach().cpu() for x in xs])

    return {key: stack(*x) if isinstance(x, list) else _host(x) for key, x in params.items()}


def state_to_jax(state: Dict) -> Dict:
    """An AdamW state of the port (``optim.adamw``) -> the reference's
    (``repro.optim.adamw``): step, and master / m / v stacked."""
    return {"step": state["step"].detach().cpu().to(torch.int32),
            **{k: params_to_jax(state[k]) for k in ("master", "m", "v")}}


def state_from_jax(np_state: Dict, cfg: ModelConfig, device: DeviceLike = None) -> Dict:
    """The reference's AdamW state (numpy or torch leaves) -> the port's."""
    device = resolve_device(device)
    step = np_state["step"]
    step = step if torch.is_tensor(step) else torch.from_numpy(np.array(step, np.int32))
    return {"step": step.to(device=device, dtype=torch.int32),
            **{k: params_from_jax(np_state[k], cfg, device) for k in ("master", "m", "v")}}
