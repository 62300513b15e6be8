"""Local (per-device) block matmul: the product every linear layer runs.

Counterpart of ``repro.dist.local.local_matmul``.  The reference hands 3-D
(B, S, d) activations to a check that accepts only 2-D operands, so its
one-device layers never reach the Pallas kernel.  Here the leading dims
fold into rows, so every projection goes through
``kernels.matmul.ops.matmul`` (the CUDA kernel on the card, the plain
version on the CPU).  Same function: fp32 accumulation, one rounding to
``out_dtype``.  Under autograd the product is K1's registered op
(``torch.ops.repro_torch.zorder_matmul``) on both devices, so its gradients
are the kernel's own backward products, on the CPU too.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.matmul.ops import matmul


def local_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` for ``a`` (..., k) and a 2-D ``b`` (k, n)."""
    if b.ndim != 2:
        raise ValueError(f"local_matmul takes a 2-D right operand, got {tuple(b.shape)}")
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
    lead = a.shape[:-1]
    rows = a.reshape(-1, a.shape[-1]).contiguous()
    return matmul(rows, b, out_dtype=out_dtype).reshape(*lead, b.shape[1])
