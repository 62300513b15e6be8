"""Deterministic synthetic token pipeline (counterpart of
``repro.data.pipeline``).

Sequences mix a learnable affine-chain signal (next = a*cur + b mod V with
probability ``signal``) with uniform noise, so small-model training shows a
real loss drop below ln(V) while staying deterministic: a batch is a pure
function of (seed, step, position), drawn from the reference's numpy
Philox stream, so its tokens and labels are the reference's bit for bit
and a restored run replays the same stream.

``device_put_batch`` moves a batch onto one device, both arrays as int64
(the index type of ``torch.gather`` in the loss and of the embedding
lookup); given a mesh, it places each array along the batch axes
(``runtime.sharding.place``), as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    signal: float = 0.9          # probability of the learnable transition
    mult: int = 31
    add: int = 17


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=(cfg.seed << 32) | step))


def synth_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """tokens/labels (global_batch, seq_len) int32; labels = next token."""
    rng = _batch_rng(cfg, step)
    b, s, v = cfg.global_batch, cfg.seq_len + 1, cfg.vocab_size
    toks = np.empty((b, s), dtype=np.int64)
    toks[:, 0] = rng.integers(0, v, size=b)
    noise = rng.integers(0, v, size=(b, s))
    use_noise = rng.random((b, s)) > cfg.signal
    for t in range(1, s):
        chain = (toks[:, t - 1] * cfg.mult + cfg.add) % v
        toks[:, t] = np.where(use_noise[:, t], noise[:, t], chain)
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


def batch_iterator(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synth_batch(cfg, step)
        step += 1


def device_put_batch(batch: Dict[str, np.ndarray], device: DeviceLike = None,
                     mesh=None) -> Dict:
    """Each array as an int64 tensor on ``device`` (default ``cuda``); with
    a mesh of more than one rank, placed on it along
    ``resolve_axis("batch", mesh)`` and whole along every other dim (a
    ``runtime.sharding.Placed`` per array).  A batch the batch axes do not
    divide raises ``ValueError``."""
    device = resolve_device(device)
    out = {k: torch.from_numpy(np.asarray(v, dtype=np.int64)).to(device)
           for k, v in batch.items()}
    if mesh is None or getattr(mesh, "size", 1) <= 1:
        return out
    from repro_torch.runtime.sharding import NamedSharding, place, resolve_axis

    axes = resolve_axis("batch", mesh)
    return {k: place(v, NamedSharding(mesh, (axes,) + (None,) * (v.ndim - 1)))
            for k, v in out.items()}
