"""Plain PyTorch version of the Z-order matmul kernel."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A @ B with fp32 accumulation, rounded once to ``out_dtype``
    (default ``a.dtype``): the kernel's contract.  bf16 products are exact
    in fp32, so upcasting first is the same function."""
    out_dtype = out_dtype or a.dtype
    return (a.float() @ b.float()).to(out_dtype)
