"""Shared helpers for the dist lowering rules (counterpart of
``repro.dist._util``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_to(x: torch.Tensor, mults: Tuple[int, ...]) -> torch.Tensor:
    """Zero-pad each dim of ``x`` up to the next multiple of ``mults``.

    Every strategy pads its operands onto the device grid this way and
    slices the product back; zero rows/columns contribute nothing to the
    matmul so the result is exact.
    """
    highs = [(-d) % m for d, m in zip(x.shape, mults)]
    if not any(highs):
        return x
    pads = []
    for hi in reversed(highs):   # F.pad lists the last dim first
        pads += [0, hi]
    return F.pad(x, pads)
