"""Launch wrappers for the hand-written Hopper Z-order matmul (K1, ``csrc/``).

Replaces ``src/repro/kernels/matmul/kernel.py::zorder_matmul``.  On the TPU
the Morton table of output tiles was the sequential VMEM block schedule,
read through scalar prefetch.  On Hopper the CTAs run in parallel, so the
same table becomes the order in which CTAs take output tiles, which governs
L2 reuse: a device int32 table built from ``repro_torch.core.zorder`` once
per ``(gm, gn, order, device)`` and cached on the device.  The k loop runs
inside the CTA with fp32 accumulators in registers; ragged edges are masked
in the kernel, so nothing is padded.

Four routes, each a set of compiled block shapes (``BLOCKS``), chosen by
``route`` as a pure function of (m, k, n, dtype, alignment); a launch the
chosen route refuses raises, it never moves to another route:

* ``wide`` (``zorder_matmul_wide.cu``): bf16, m > ``THIN_MAX_M``.  One
  persistent CTA per SM walks the Morton table; a producer thread feeds a
  TMA ring, two warpgroups run ``wgmma``.  Bound by the tensor cores.
* ``thin`` (``zorder_matmul_thin.cu``): bf16, m <= ``THIN_MAX_M``.  Split-K
  over ``split_plan`` slices, cp.async streaming and ``mma.sync``, partials
  summed in a fixed order by the last CTA of each tile.  Bound by the
  weight bytes.
* ``wmma`` (``zorder_matmul.cu``): bf16 operands that 16-byte copies and
  TMA cannot take (k or n not a multiple of 8, k = 0, or a base not 16-byte
  aligned).
* ``fma`` (``zorder_matmul.cu``): fp32, plain FMA.

The wide and thin routes read each operand as it is stored: row-major, or
the ``.t()`` of a row-major tensor (a tied embedding as the LM head, the
backward's B^T and A^T): ``layout`` reads it from the strides, and the
flags ``a_t`` / ``b_t`` of their C entry points pass it on.
The wmma and fma routes read row-major operands only (``ops.matmul``
copies a transposed one for them).

``launches`` counts accepted launches, one per product, and
``launches_by_route`` the same per route; ``reset_launches`` zeroes both,
so a run can show which kernels its products went through;
``trace_launches`` also lists each launch's (m, n, k, route).  The plan
engine's rank threads launch concurrently, each on its own stream, so the
counters, the tile tables and the split-K counter arrays (one per stream)
are kept under one lock.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.zorder import rowmajor_schedule, zorder_schedule
from repro_torch.device import bind_thread

Blocks = Tuple[int, int, int]

# The compiled block shapes (block_m, block_n, block_k) of each route; the
# .cu files instantiate exactly these.
ROUTE_BLOCKS: Dict[Tuple[torch.dtype, str], Tuple[Blocks, ...]] = {
    (torch.bfloat16, "wide"): ((128, 256, 64), (128, 128, 64)),
    (torch.bfloat16, "thin"): ((16, 64, 64), (64, 64, 64)),
    (torch.bfloat16, "wmma"): ((64, 64, 32), (16, 64, 128)),
    (torch.float32, "fma"): ((64, 64, 16), (16, 64, 32)),
}
BLOCKS: Dict[torch.dtype, Tuple[Blocks, ...]] = {}
ROUTE_OF: Dict[Tuple[torch.dtype, Blocks], str] = {}
for (_dt, _route), _shapes in ROUTE_BLOCKS.items():
    BLOCKS[_dt] = BLOCKS.get(_dt, ()) + _shapes
    ROUTE_OF.update({(_dt, s): _route for s in _shapes})
ROUTES = ("wide", "thin", "wmma", "fma")

SMALL_M = 16       # the 16-row tiles take m <= 16 (thin and wmma routes)
# bf16 products with more rows take the wide route.  Measured on an H100
# at Llama-3.2-1B's seven layer shapes (chip_smoke.py's crossover phase):
# the thin route wins at m = 64, the wide route's 128 x 128 tile from
# m = 128 on.
THIN_MAX_M = 64
# The wide route's 128 x 256 tile needs this many tiles (two per SM of an
# H100) to beat the 128 x 128 tile, whose CTAs then fill the card better.
WIDE_256_MIN_TILES = 264
# Split-K fills at most SPLIT_CTAS_PER_SM CTAs per SM (the thin tiles'
# residency), so a product runs in one wave, and never sums more than
# MAX_SPLITS partials per output (the .cu file's kMaxSplits).
SPLIT_CTAS_PER_SM = 2
MAX_SPLITS = 16
# Stages of each tile's shared-memory ring (the .cu files' STAGES).
STAGES = {(128, 256, 64): 4, (128, 128, 64): 6, (16, 64, 64): 8, (64, 64, 64): 6,
          (64, 64, 32): 4, (16, 64, 128): 4}
# A block may use 227 KB of the SM's shared memory (above 48 KB only as
# dynamic shared memory, which the launchers opt into).
SMEM_LIMIT = 227 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
launches_by_route: Dict[str, int] = dict.fromkeys(ROUTES, 0)
_tile_tables: Dict[Tuple[int, int, str, torch.device], torch.Tensor] = {}
_counters: Dict[Tuple[torch.device, Optional[int]], torch.Tensor] = {}
_sm_counts: Dict[torch.device, int] = {}
_trace: Optional[List[Tuple[int, int, int, str]]] = None
_lock = threading.RLock()


def reset_launches() -> None:
    global launches
    with _lock:
        launches = 0
        for r in ROUTES:
            launches_by_route[r] = 0


def count_launch(route: str, m: int, n: int, k: int) -> None:
    """Count one accepted launch of ``route`` (the only place the counters
    move)."""
    global launches
    with _lock:
        launches += 1
        launches_by_route[route] += 1
        if _trace is not None:
            _trace.append((m, n, k, route))


@contextlib.contextmanager
def trace_launches():
    """Within the scope, list every launch as (m, n, k, route)."""
    global _trace
    with _lock:
        prev, _trace = _trace, []
        out = _trace
    try:
        yield out
    finally:
        with _lock:
            _trace = prev


def smem_bytes(block_m: int, block_n: int, block_k: int, dtype: torch.dtype,
               a_t: bool = False, b_t: bool = False) -> int:
    """Shared memory one CTA of the compiled kernel claims with the
    operands stored as ``a_t`` / ``b_t`` say (mirrors the ``kSmemBytes`` of
    the tile structs in the .cu files)."""
    blocks = (block_m, block_n, block_k)
    route = ROUTE_OF[dtype, blocks]
    if route == "wide":   # TMA ring, full + empty mbarrier a stage, 1024-byte alignment
        return STAGES[blocks] * (block_m + block_n) * block_k * 2 + 2 * STAGES[blocks] * 8 + 1024
    if route == "thin":   # cp.async ring of the blocks as stored, rows padded by 8 elements
        a = block_k * (block_m + 8) if a_t else block_m * (block_k + 8)
        b = block_n * (block_k + 8) if b_t else block_k * (block_n + 8)
        return STAGES[blocks] * (a + b) * 2
    if route == "wmma":
        pipe = STAGES[blocks] * (block_m * (block_k + 8) + block_k * (block_n + 8)) * 2
        return max(pipe, block_m * (block_n + 4) * 4)
    return block_k * ((block_m + 1) + (block_n + 1)) * 4


def layout(t: torch.Tensor) -> Optional[bool]:
    """How a 2-D operand is stored: False row-major contiguous, True the
    ``.t()`` of a row-major contiguous tensor (strides (1, rows)), None
    anything else (a strided slice, an expanded tensor)."""
    if t.is_contiguous():
        return False
    if t.stride() == (1, t.shape[0]):
        return True
    return None


def vectorizable(k: int, n: int, m: int = 0, a_t: bool = False, b_t: bool = False) -> bool:
    """Whether 16-byte copies and TMA boxes take the bf16 operands as
    stored: k > 0 and every stored row a whole number of 16-byte chunks
    (the output's n; A's k, or m where A is stored transposed; k where B
    is stored transposed)."""
    return (k > 0 and n % 8 == 0 and (m % 8 == 0 if a_t else k % 8 == 0)
            and (not b_t or k % 8 == 0))


def route(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool = True,
          a_t: bool = False, b_t: bool = False) -> str:
    """The route of an (m, k) x (k, n) product; ``aligned`` says whether
    both bases are 16-byte aligned, ``a_t`` / ``b_t`` whether A / B is
    stored transposed."""
    if dtype == torch.float32:
        return "fma"
    if not (aligned and vectorizable(k, n, m, a_t, b_t)):
        return "wmma"
    return "thin" if m <= THIN_MAX_M else "wide"


def default_blocks(m: int, n: int, k: int, dtype: torch.dtype,
                   aligned: bool = True, a_t: bool = False, b_t: bool = False) -> Blocks:
    """The compiled block shape for an (m, k) x (k, n) product on its
    route: the 16-row tile for m <= 16 (thin, wmma, fma), the wide route's
    128 x 256 tile from ``WIDE_256_MIN_TILES`` such tiles up, 128 x 128
    below."""
    r = route(m, n, k, dtype, aligned, a_t, b_t)
    shapes = ROUTE_BLOCKS[dtype, r]
    if r == "thin":
        return shapes[0] if m <= SMALL_M else shapes[1]
    if r in ("wmma", "fma"):
        return shapes[1] if m <= SMALL_M else shapes[0]
    big, small = shapes
    return big if -(-m // big[0]) * -(-n // big[1]) >= WIDE_256_MIN_TILES else small


def split_plan(k: int, n: int, sms: int, block_n: int = 64, block_k: int = 64) -> Tuple[int, int]:
    """(splits, blocks per split) of the thin route: each output tile's
    ``ceil(k / block_k)`` k blocks cut into ``splits`` consecutive slices of
    ``blocks per split`` (the last may be shorter, none is empty): as many
    as fit ``SPLIT_CTAS_PER_SM`` CTAs per SM over the ``ceil(n / block_n)``
    column tiles, at most ``MAX_SPLITS``.  A pure function of (k, n, SM
    count): never of m or of the data, so a row's bits do not depend on
    the batch it is in."""
    nkb = -(-k // block_k)
    if nkb <= 1:
        return 1, max(nkb, 1)
    gn = -(-n // block_n)
    want = min(nkb, MAX_SPLITS, max(1, SPLIT_CTAS_PER_SM * sms // gn))
    per = -(-nkb // want)
    return -(-nkb // per), per


def tile_table(gm: int, gn: int, order: str, device: torch.device) -> torch.Tensor:
    """Device int32 table ``[oi..., oj...]`` of the output-tile visit
    order, uploaded once per (gm, gn, order, device)."""
    key = (gm, gn, order, device)
    with _lock:
        table = _tile_tables.get(key)
        if table is None:
            if order == "zorder":
                ij = [(i, j) for (i, j, _k) in zorder_schedule(gm, gn, 1)]
            elif order == "rowmajor":
                ij = [(i, j) for (i, j, _k) in rowmajor_schedule(gm, gn, 1)]
            else:
                raise ValueError(f"unknown order {order!r}")
            flat = [i for i, _ in ij] + [j for _, j in ij]
            table = torch.tensor(flat, dtype=torch.int32, device=device)
            _tile_tables[key] = table
        return table


def sm_count(device: torch.device) -> int:
    with _lock:
        count = _sm_counts.get(device)
        if count is None:
            count = torch.cuda.get_device_properties(device).multi_processor_count
            _sm_counts[device] = count
        return count


def split_counters(device: torch.device, ntiles: int,
                   stream: Optional[int] = None) -> torch.Tensor:
    """Zeroed int32 arrival counters, one per output tile, shared by every
    thin-route launch on one stream of the device (``stream``, a CUDA
    stream handle; by default the device's current stream): the last CTA
    of a tile resets its counter, so launches in stream order find them
    zero.  Each stream has its own array, so launches on two streams may
    run at once (the plan engine's rank streams).  An array is allocated
    and zeroed on its stream outside graph capture; a launch captured
    before any eager one on its stream takes its own array, zeroed inside
    the graph."""
    if stream is None and device.type == "cuda":
        stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, stream)
    with _lock:
        cnt = _counters.get(key)
        if cnt is None or cnt.numel() < ntiles:
            fresh = torch.zeros(max(ntiles, 4096), dtype=torch.int32, device=device)
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                return fresh
            cnt = _counters[key] = fresh
        return cnt


def prepare_capture_stream(stream: "torch.cuda.Stream") -> None:
    """Give the stream a CUDA graph will be captured on its split-K
    counter array now, zeroed on that stream: without one, every thin
    launch captured there would take its own array, zeroed by a node of
    the graph.  Call it before the capture starts."""
    with torch.cuda.stream(stream):
        split_counters(stream.device, 1)


def zorder_matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int, block_n: int,
                  block_k: int, out_dtype: torch.dtype, order: str = "zorder") -> torch.Tensor:
    """Launch the route of ``(block_m, block_n, block_k)`` on CUDA tensors
    ``a`` (m, k) and ``b`` (k, n), each read as ``layout`` finds it stored.

    The caller (``ops.matmul``) has checked device, type, shape, alignment
    and blocks.  Launches on the current stream without synchronising;
    raises if the launch is refused (each C entry point also refuses block
    shapes and operands it was not compiled for)."""
    from ._build import load

    if a.device.type != "cuda":
        raise ValueError(f"zorder_matmul runs on CUDA tensors, got {a.device}")
    bind_thread(a.device)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    r = ROUTE_OF[a.dtype, (block_m, block_n, block_k)]
    a_t, b_t = layout(a), layout(b)
    if a_t is None or b_t is None:
        raise ValueError("operands must be row-major contiguous or the .t() of a "
                         "row-major contiguous tensor")
    if (a_t or b_t) and r not in ("wide", "thin"):
        raise ValueError(f"the {r} route reads row-major operands only")
    gm, gn = -(-m // block_m), -(-n // block_n)
    ntiles = gm * gn
    tiles = tile_table(gm, gn, order, a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib = load()
    if r == "wide":
        grid = min(sm_count(a.device), ntiles)
        rc = lib.zorder_matmul_wide_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), tiles.data_ptr(), ntiles, m, n, k,
            int(a_t), int(b_t), _DTYPE_CODE[out_dtype], block_m, block_n, block_k, grid, stream)
    elif r == "thin":
        splits, per = split_plan(k, n, sm_count(a.device), block_n, block_k)
        ws = cnt = None
        if splits > 1:
            ws = torch.empty(splits * m * n, dtype=torch.float32, device=a.device)
            cnt = split_counters(a.device, ntiles, stream)
        rc = lib.zorder_matmul_thin_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            cnt.data_ptr() if cnt is not None else None, tiles.data_ptr(), ntiles, m, n, k,
            int(a_t), int(b_t), _DTYPE_CODE[out_dtype], block_m, block_n, block_k, splits, per,
            stream)
    else:
        rc = lib.zorder_matmul_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), tiles.data_ptr(), ntiles,
            m, n, k, _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype],
            block_m, block_n, block_k, stream)
    if rc != 0:
        raise RuntimeError(f"zorder_matmul ({r} route) launch failed: "
                           f"{lib.zorder_matmul_error_string(rc).decode()} ({rc})")
    count_launch(r, m, n, k)
    return out

