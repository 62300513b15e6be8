"""Public Z-order matmul: checks its inputs, then runs the CUDA kernel on a
CUDA tensor or the plain version on a CPU tensor.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.  Unlike the reference (``repro/kernels/matmul/ops.py``), no shape
is too small for the kernel: decode multiplies batch-sized rows (4-8), and
sending those to a library call would take every decode product off the
kernel.  Ragged shapes are masked inside the kernel instead of padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel
from .ref import matmul_ref

DTYPES = (torch.float32, torch.bfloat16)


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    block_k: Optional[int] = None,
    order: str = "zorder",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """C = A @ B, fp32 accumulation, rounded once to ``out_dtype``
    (default ``a.dtype``).  ``a`` (m, k) and ``b`` (k, n) are contiguous,
    of one type (fp32 or bf16) and on one device.  Blocks default to
    ``kernel.default_blocks``; explicit blocks must be a compiled shape.
    ``order`` is "zorder" (the paper's Sec. 4.3 schedule) or "rowmajor"."""
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"operands must both be float32 or bfloat16, got "
                         f"{a.dtype} and {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"operands must be 2-D, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {a.shape[1]} vs {b.shape[0]}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("operands must be contiguous (row-major)")
    if order not in ("zorder", "rowmajor"):
        raise ValueError(f"unknown order {order!r}")
    m, k = a.shape
    n = b.shape[1]
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    bm, bn, bk = kernel.default_blocks(m, n, k, a.dtype, aligned)
    blocks = (block_m or bm, block_n or bn, block_k or bk)
    if blocks not in kernel.BLOCKS[a.dtype]:
        raise ValueError(f"blocks {blocks} are not compiled for {a.dtype}; "
                         f"choose from {kernel.BLOCKS[a.dtype]}")
    route = kernel.ROUTE_OF[a.dtype, blocks]
    if route in ("wide", "thin") and not (aligned and kernel.vectorizable(k, n)):
        raise ValueError(f"the {route} route's blocks {blocks} take k and n multiples of 8 "
                         f"(k > 0) and 16-byte aligned bases; got k={k}, n={n}")
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    return kernel.zorder_matmul(a, b, block_m=blocks[0], block_n=blocks[1],
                                block_k=blocks[2], out_dtype=out_dtype, order=order)
