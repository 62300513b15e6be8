"""Intra-device lowering: the plan's tiling as the rank's block multiply.

Counterpart of ``repro.plan.lower_pallas``.  A ``SchedulePlan`` carries a
``TilingPlan`` -- the iterated-wreath-product (Z-order) bits of Sec. 4.3.
``lower_local(plan)`` turns it into the local block-multiply callable the
per-rank bodies run:

  * default tiling -> ``repro_torch.dist.local.local_matmul`` verbatim (K1
    on the card with its default blocks and the Z-order tile walk, the
    plain version on the CPU);
  * an order or blocks override, or tuned blocks (``tiling.tuned``, from
    a tuning table's bucket) -> a closure over
    ``repro_torch.kernels.matmul.ops.matmul`` with those arguments.  A
    block shape K1 was not compiled for raises there; nothing falls back
    to the plain version or to other blocks on the card.  An operand
    whose base is not 16-byte aligned (a view into a larger buffer; the
    wide and thin routes read 16-byte chunks) is copied to a fresh,
    aligned buffer first, so the plan's blocks -- the ones a tuning table
    timed -- run on every call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import aligned16
from repro_torch.dist.local import local_matmul
from repro_torch.kernels.matmul.ops import matmul

from .ir import SchedulePlan, TilingPlan


def lower_tiling(tiling: TilingPlan):
    """Local-matmul callable executing ``tiling`` (see module docstring)."""
    if tiling.is_default:
        return local_matmul

    def tiled_local_matmul(a: torch.Tensor, b: torch.Tensor, *,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if out_dtype is None:
            out_dtype = torch.promote_types(a.dtype, b.dtype)
        rows = _aligned(a.reshape(-1, a.shape[-1]).contiguous())
        out = matmul(rows, _aligned(b), block_m=tiling.block_m, block_n=tiling.block_n,
                     block_k=tiling.block_k, order=tiling.order, out_dtype=out_dtype)
        return out.reshape(*a.shape[:-1], b.shape[1])

    return tiled_local_matmul


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it in a fresh (aligned) buffer when its base is
    not 16-byte aligned."""
    return x if aligned16(x) else x.clone()


def lower_local(plan: SchedulePlan):
    """Per-device lowering of ``plan``: its tiling as a callable."""
    return lower_tiling(plan.tiling)
