"""Public Z-order matmul: checks its inputs, then runs the CUDA kernel on a
CUDA tensor or the plain version on a CPU tensor.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises.  Unlike the reference (``repro/kernels/matmul/ops.py``), no shape
is too small for the kernel: decode multiplies batch-sized rows (4-8), and
sending those to a library call would take every decode product off the
kernel.  Ragged shapes are masked inside the kernel instead of padded.

With ``repro_torch.obs`` tracing enabled, every launch counts in
``kernel.matmul.launches{route}``, and a call outside CUDA-graph capture
is a ``kernel.matmul`` span around the launch itself, so the profiler
links K1's kernels to that range.  Its device time lands in the
``kernel.matmul.us`` histogram: on the card a pair of CUDA events around
the launch, resolved when the histogram is read, so tracing never waits
for the device (the reference blocks on each call instead); the host
clock on the CPU.  Its FLOPs land in ``kernel.matmul.flops`` and, on the
card, its share of its roofline (``bound_s``) in
``kernel.matmul.roofline_fraction``.  Disabled mode adds one flag read and
nothing else.

Each operand is row-major contiguous or the ``.t()`` of a row-major
contiguous tensor with a 16-byte aligned base (a tied embedding read as the
LM head, the backward's B^T and A^T); any other layout raises.  The wide
and thin routes read a transposed operand in place; for the wmma and fma
routes, which read row-major operands only, ``matmul`` hands over a
row-major copy (``_fresh``, visible in a trace) and keeps the route.  The
route and the copies follow from the dtype, the shape and the layouts,
never from the device.  On the CPU the plain version multiplies row-major
copies, so a result does not depend on its operands' layout.

Under autograd (grad enabled and an operand that requires grad) the
product is the registered op ``torch.ops.repro_torch.zorder_matmul``: its
backward computes dA = dC B^T and dB = A^T dC through ``matmul`` again, on
the operands' transposed views (no copy on the wide and thin routes), so
all three products run on the kernel; the one exception is a bf16 product
with an fp32 output (the unembedding's), whose fp32 cotangent is
multiplied as the reference does (``_backward``).  Being
an op of the dispatcher, it is what a selective-checkpoint policy sees and
keeps (``models.lm.remat``, ``"dots"``).  Without grad, ``matmul`` calls
the kernel directly: no dispatcher hop in eager or captured serving.  A
fake tensor, or a dispatch mode active in the thread (the cost counter,
``repro_torch.roofline.hlo_stats``, or ``FakeTensorMode``), also takes the
op, so a mode sees K1 as one call and a fake run never reaches the kernel;
a fake operand's alignment is where the card's allocator would put it
(``device.aligned16``), so the blocks and the route are the card's.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from repro_torch import obs
from repro_torch.device import aligned16, dispatch_mode_active, is_fake
from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS

from . import kernel
from .kernel import layout
from .ref import matmul_ref

DTYPES = (torch.float32, torch.bfloat16)


def accepts(k: int, n: int, dtype: torch.dtype, blocks, aligned: bool = True, *,
            m: int = 0, a_t: bool = False, b_t: bool = False) -> bool:
    """Whether ``matmul`` takes ``blocks`` for a ``dtype`` (m, k) x (k, n)
    product (``aligned``: both bases 16-byte aligned; ``a_t`` / ``b_t``: A /
    B stored transposed): a compiled shape of the type, and for the wide
    and thin routes operands their 16-byte copies can read as stored."""
    blocks = tuple(blocks)
    if blocks not in kernel.BLOCKS.get(dtype, ()):
        return False
    route = kernel.ROUTE_OF[dtype, blocks]
    return route not in ("wide", "thin") or (aligned
                                             and kernel.vectorizable(k, n, m, a_t, b_t))


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
    (default ``a.dtype``).  ``a`` (m, k) and ``b`` (k, n) are each
    row-major or the ``.t()`` of a row-major tensor with an aligned base
    (module docstring), of one type (fp32 or bf16) and on one device.
    Blocks default to ``kernel.default_blocks``; explicit blocks must be a
    compiled shape.  ``order`` is "zorder" (the paper's Sec. 4.3 schedule)
    or "rowmajor"."""
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
    a_t, b_t = layout(a), layout(b)
    if a_t is None or b_t is None:
        raise ValueError("operands must be row-major contiguous or the .t() of a "
                         "row-major contiguous tensor")
    if (a_t and not aligned16(a)) or (b_t and not aligned16(b)):
        raise ValueError("a transposed operand needs a 16-byte aligned base")
    if order not in ("zorder", "rowmajor"):
        raise ValueError(f"unknown order {order!r}")
    m, k = a.shape
    n = b.shape[1]
    aligned = aligned16(a) and aligned16(b)
    bm, bn, bk = kernel.default_blocks(m, n, k, a.dtype, aligned, a_t, b_t)
    blocks = (block_m or bm, block_n or bn, block_k or bk)
    if blocks not in kernel.BLOCKS[a.dtype]:
        raise ValueError(f"blocks {blocks} are not compiled for {a.dtype}; "
                         f"choose from {kernel.BLOCKS[a.dtype]}")
    if not accepts(k, n, a.dtype, blocks, aligned, m=m, a_t=a_t, b_t=b_t):
        raise ValueError(f"the {kernel.ROUTE_OF[a.dtype, blocks]} route's blocks {blocks} "
                         f"take stored rows of multiples of 8 (n; k, or m for a transposed "
                         f"A; k for a transposed B; k > 0) and 16-byte aligned bases; "
                         f"got m={m}, k={k}, n={n}, transposed A {a_t}, B {b_t}")
    if kernel.ROUTE_OF[a.dtype, blocks] not in ("wide", "thin"):
        # the wmma and fma routes read row-major operands: copy, keep the route
        a = _fresh(a, a.dtype) if a_t else a
        b = _fresh(b, b.dtype) if b_t else b
    if (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)) \
            or is_fake(a) or dispatch_mode_active():
        return zorder_matmul_op(a, b, list(blocks), order, out_dtype)
    return _launch(a, b, blocks, order, out_dtype)


def _launch(a, b, blocks, order, out_dtype):
    if obs.enabled():
        route = kernel.ROUTE_OF[a.dtype, blocks] if a.device.type == "cuda" else "plain"
        obs.counter("kernel.matmul.launches").inc(route=route)
        # a captured launch is timed by its layer's graph events instead
        if not (a.device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            return _observed(a, b, blocks, order, out_dtype, route)
    return _run(a, b, blocks, order, out_dtype)


def bound_s(m: int, n: int, k: int, dtype: torch.dtype, out_dtype: torch.dtype) -> float:
    """The least time of an (m, k) x (k, n) product on the card: the larger
    of its FLOPs at ``dtype``'s published peak and its bytes (each operand
    read once, the output written once) at the memory rate.  The reference
    divides a launch's FLOP rate by the compute peak alone; here a thin,
    byte-bound launch is held to its byte bound, an intended divergence."""
    size = torch.empty((), dtype=dtype).element_size()
    out_size = torch.empty((), dtype=out_dtype).element_size()
    flops = 2.0 * m * n * k
    nbytes = (m * k + k * n) * size + m * n * out_size
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BW)


def _fresh(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous, with a 16-byte aligned base (what the
    wide and thin routes read)."""
    t = t.to(dtype).contiguous()
    return t if aligned16(t) else t.clone()


@torch.library.custom_op("repro_torch::zorder_matmul", mutates_args=(),
                         device_types=("cpu", "cuda"))
def zorder_matmul_op(a: torch.Tensor, b: torch.Tensor, blocks: List[int], order: str,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """C = A @ B through the kernel (the plain version on the CPU), as a
    differentiable op of the dispatcher (module docstring).  ``matmul``
    checks the arguments first.  The output is always a new tensor."""
    return _launch(a, b, tuple(blocks), order, out_dtype)


@zorder_matmul_op.register_fake
def _(a, b, blocks, order, out_dtype):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype)


def _save_operands(ctx, inputs, output):
    a, b, _, order, _ = inputs
    ctx.save_for_backward(a, b)
    ctx.order = order


def _backward(ctx, dc):
    """dA = dC B^T, dB = A^T dC through ``matmul``, on the saved operands'
    transposed views: the wide and thin routes read them in place, the
    fp32 route gets its row-major copies from ``matmul``.  A cotangent in a
    narrower type than the operands (an fp32 product rounded to bf16) is
    cast up to theirs first.

    A bf16 product with fp32 output (the unembedding's) gets an fp32
    cotangent.  The reference differentiates its ``jnp.matmul(x, w,
    preferred_element_type=f32)`` into ``dot_general(f32 ct, bf16 w,
    preferred_element_type=f32)`` and a convert to bf16: XLA products
    outside its Pallas kernel.  Here too: one fp32 ``torch.matmul`` per
    gradient on the upcast operands (bf16 values are exact in fp32), one
    rounding to the operand's type, and no K1 launch; K1's fp32 route
    would be slower than those products."""
    a, b = ctx.saved_tensors
    da = db = None
    if a.dtype == torch.bfloat16 and dc.dtype == torch.float32:
        if ctx.needs_input_grad[0]:
            da = torch.matmul(dc, b.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.matmul(a.float().t(), dc).to(b.dtype)
        return da, db, None, None, None
    g = _fresh(dc, a.dtype)
    if ctx.needs_input_grad[0]:
        da = matmul(g, _transposed(b), order=ctx.order, out_dtype=a.dtype)
    if ctx.needs_input_grad[1]:
        db = matmul(_transposed(a), g, order=ctx.order, out_dtype=b.dtype)
    return da, db, None, None, None


def _transposed(t: torch.Tensor) -> torch.Tensor:
    """``t.t()`` as ``matmul`` takes it: the view, or where ``t``'s base is
    not 16-byte aligned (a transposed view needs one) a row-major copy."""
    return t.t() if aligned16(t) else _fresh(t.t(), t.dtype)


zorder_matmul_op.register_autograd(_backward, setup_context=_save_operands)


def _run(a, b, blocks, order, out_dtype):
    if a.device.type == "cpu":   # row-major copies: the same bits whatever the layout
        return matmul_ref(a.contiguous(), b.contiguous(), out_dtype)
    return kernel.zorder_matmul(a, b, block_m=blocks[0], block_n=blocks[1],
                                block_k=blocks[2], out_dtype=out_dtype, order=order)


def _observed(a, b, blocks, order, out_dtype, route):
    """``_run`` inside a ``kernel.matmul`` span, timed (module docstring)."""
    m, k = a.shape
    n = b.shape[1]
    with obs.span("kernel.matmul", m=m, n=n, k=k, order=order, route=route):
        if a.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _run(a, b, blocks, order, out_dtype)
            end.record()
        else:
            t0 = time.perf_counter()
            out = _run(a, b, blocks, order, out_dtype)
            dt = time.perf_counter() - t0
    obs.counter("kernel.matmul.flops").inc(2.0 * m * n * k)
    if a.device.type == "cuda":
        elapsed = _Elapsed(start, end)
        bound = bound_s(m, n, k, a.dtype, out_dtype)
        obs.histogram("kernel.matmul.us").defer(lambda: elapsed.seconds() * 1e6)
        obs.histogram("kernel.matmul.roofline_fraction").defer(
            lambda: bound / elapsed.seconds() if elapsed.seconds() > 0 else None)
    else:
        obs.histogram("kernel.matmul.us").observe(dt * 1e6)
    return out


class _Elapsed:
    """Seconds between two recorded CUDA events, waited for and read once."""

    __slots__ = ("start", "end", "_s")

    def __init__(self, start, end):
        self.start, self.end, self._s = start, end, None

    def seconds(self) -> float:
        if self._s is None:
            self.end.synchronize()
            self._s = self.start.elapsed_time(self.end) / 1e3
        return self._s
