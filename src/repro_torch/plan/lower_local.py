"""Intra-device lowering: the plan's tiling as the rank's block multiply.

Counterpart of ``repro.plan.lower_pallas``.  A ``SchedulePlan`` carries a
``TilingPlan`` -- the iterated-wreath-product (Z-order) bits of Sec. 4.3.
``lower_local(plan)`` turns it into the local block-multiply callable the
per-rank bodies run:

  * default tiling -> ``repro_torch.dist.local.local_matmul`` verbatim (K1
    on the card with its default blocks and the Z-order tile walk, the
    plain version on the CPU);
  * an order or blocks override -> a closure over
    ``repro_torch.kernels.matmul.ops.matmul`` with those arguments.  A block
    shape K1 was not compiled for raises there; nothing falls back to the
    plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

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
        rows = a.reshape(-1, a.shape[-1]).contiguous()
        out = matmul(rows, b, order=tiling.order, block_m=tiling.block_m,
                     block_n=tiling.block_n, block_k=tiling.block_k, out_dtype=out_dtype)
        return out.reshape(*a.shape[:-1], b.shape[1])

    return tiled_local_matmul


def lower_local(plan: SchedulePlan):
    """Per-device lowering of ``plan``: its tiling as a callable."""
    return lower_tiling(plan.tiling)
