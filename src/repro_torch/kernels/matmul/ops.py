"""Public Z-order matmul: checks its inputs, then runs the CUDA kernel on a
CUDA tensor or the plain version on a CPU tensor.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.  Unlike the reference (``repro/kernels/matmul/ops.py``), no shape
is too small for the kernel: decode multiplies batch-sized rows (4-8), and
sending those to a library call would take every decode product off the
kernel.  Ragged shapes are masked inside the kernel instead of padded.

With ``repro_torch.obs`` tracing enabled, a call outside CUDA-graph
capture is a ``kernel.matmul`` span: its device time (CUDA events,
synchronised at span end, as the reference's ``block_until_ready``; the
host clock on the CPU) lands in the ``kernel.matmul.us`` histogram, its
FLOPs in ``kernel.matmul.flops`` and, on the card, its share of the
published peak in ``kernel.matmul.roofline_fraction``.  Disabled mode adds
one flag read and nothing else.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch import obs

from . import kernel
from .ref import matmul_ref

DTYPES = (torch.float32, torch.bfloat16)
# H100 SXM published dense peaks (NVIDIA data sheet, 700 W): bf16 tensor
# cores, fp32 outside the tensor cores.  Only the roofline-fraction metric
# reads them.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def accepts(k: int, n: int, dtype: torch.dtype, blocks, aligned: bool = True) -> bool:
    """Whether ``matmul`` takes ``blocks`` for a ``dtype`` product with
    contraction ``k`` and ``n`` columns (``aligned``: both bases 16-byte
    aligned): a compiled shape of the type, and for the wide and thin
    routes operands their 16-byte copies can read."""
    blocks = tuple(blocks)
    if blocks not in kernel.BLOCKS.get(dtype, ()):
        return False
    route = kernel.ROUTE_OF[dtype, blocks]
    return route not in ("wide", "thin") or (aligned and kernel.vectorizable(k, n))


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
    if not accepts(k, n, a.dtype, blocks, aligned):
        raise ValueError(f"the {kernel.ROUTE_OF[a.dtype, blocks]} route's blocks {blocks} "
                         f"take k and n multiples of 8 (k > 0) and 16-byte aligned bases; "
                         f"got k={k}, n={n}")
    # nothing to time (or to wait for) inside a CUDA-graph capture
    if obs.enabled() and not (a.device.type == "cuda"
                              and torch.cuda.is_current_stream_capturing()):
        return _observed(a, b, blocks, order, out_dtype)
    return _run(a, b, blocks, order, out_dtype)


def _run(a, b, blocks, order, out_dtype):
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    return kernel.zorder_matmul(a, b, block_m=blocks[0], block_n=blocks[1],
                                block_k=blocks[2], out_dtype=out_dtype, order=order)


def _observed(a, b, blocks, order, out_dtype):
    """``_run`` inside a ``kernel.matmul`` span, timed (module docstring)."""
    m, k = a.shape
    n = b.shape[1]
    route = kernel.ROUTE_OF[a.dtype, blocks] if a.device.type == "cuda" else "plain"
    with obs.span("kernel.matmul", m=m, n=n, k=k, order=order, route=route):
        if a.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _run(a, b, blocks, order, out_dtype)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = _run(a, b, blocks, order, out_dtype)
            dt = time.perf_counter() - t0
    flops = 2.0 * m * n * k
    obs.histogram("kernel.matmul.us").observe(dt * 1e6)
    obs.counter("kernel.matmul.flops").inc(flops)
    if a.device.type == "cuda" and dt > 0:
        obs.histogram("kernel.matmul.roofline_fraction").observe(
            flops / dt / PEAK_FLOPS[a.dtype])
    return out
