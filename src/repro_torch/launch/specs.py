"""Fake tensors standing in for every model input and state (no memory).

Counterpart of ``repro.launch.specs``, whose ``jax.ShapeDtypeStruct`` trees
become fake tensors (``FakeTensorMode``: a shape, a type and a device, no
storage).  ``input_specs(arch, shape, device)`` is the abstract batch of a
shape cell; ``abstract_params`` / ``abstract_cache`` /
``abstract_opt_state`` run ``model.init`` / ``init_cache`` / ``adamw.init``
on fake tensors, so a full-size cell touches no memory.  Each runs under
the fake mode active in the calling thread, or a new one.  A seeded CPU
``torch.Generator`` draws nothing under a fake mode, so the device of the
abstract tree is ``device``'s; fake CUDA tensors need a CUDA build of torch
on a machine with a card (``repro_torch.device.resolve_device``).

Audio frontends are stubs, as in the reference: seamless gets precomputed
frame embeddings (``SRC_FRAMES_32K`` of them for the prefill and train
cells).  Tokens are int64, the port's index type (the reference's are
int32); a decode cell's slot ``pos`` is a 0-d int64 tensor, the form
``decode_step`` takes on the device.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, ShapeCell, get_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.tree import tree_leaves

SRC_FRAMES_32K = 4096   # seamless encoder frames for the prefill/train cells


def fake_mode(inputs=()) -> FakeTensorMode:
    """The fake mode of ``inputs`` or the one active in the calling
    thread, or a new one."""
    return detect_fake_mode(list(inputs)) or FakeTensorMode()


def _cell(shape: Union[str, ShapeCell]) -> ShapeCell:
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(arch: str, shape: Union[str, ShapeCell], device="cuda",
                cfg: Optional[ModelConfig] = None) -> Dict[str, torch.Tensor]:
    """The abstract batch of ``shape`` (a name of ``SHAPES`` or a cell)."""
    cfg = cfg if cfg is not None else get_config(arch)
    cell = _cell(shape)
    b, s = cell.global_batch, cell.seq_len
    with fake_mode():
        def tok(*sh):
            return torch.empty(sh, dtype=torch.int64, device=device)

        def src():
            return torch.empty((b, min(s, SRC_FRAMES_32K), cfg.d_model), dtype=torch.bfloat16,
                               device=device)

        if cell.kind == "train":
            batch = {"tokens": tok(b, s), "labels": tok(b, s)}
            if cfg.family == "audio":
                batch["src_embed"] = src()
            return batch
        if cell.kind == "prefill":
            batch = {"tokens": tok(b, s)}
            if cfg.family == "audio":
                batch["src_embed"] = src()
            return batch
        if cell.kind == "decode":
            return {"tokens": tok(b, 1), "pos": tok()}
    raise ValueError(cell.kind)


def abstract_params(cfg: ModelConfig, device="cuda"):
    """(model, its parameters as fake tensors)."""
    model = build_model(cfg)
    with fake_mode():
        return model, model.init(torch.Generator().manual_seed(0), device)


def abstract_cache(model, cfg: ModelConfig, shape: Union[str, ShapeCell], device="cuda"):
    cell = _cell(shape)
    b, s = cell.global_batch, cell.seq_len
    with fake_mode():
        if cfg.family == "audio":
            return model.init_cache(b, s, device, src_len=SRC_FRAMES_32K)
        return model.init_cache(b, s, device)


def abstract_opt_state(params):
    """AdamW's state (step, fp32 master, m, v) around ``params``."""
    from repro_torch.optim import adamw

    with fake_mode(tree_leaves(params)):
        return adamw.init(params)
