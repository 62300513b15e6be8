"""Launch wrapper for the hand-written Hopper Z-order matmul (``csrc/zorder_matmul.cu``).

Replaces ``src/repro/kernels/matmul/kernel.py::zorder_matmul``.  On the TPU
the Morton table of output tiles was the sequential VMEM block schedule,
read through scalar prefetch.  On Hopper the CTAs run in parallel, so the
same table becomes the CTA rasterisation that governs L2 reuse: CTA ``s``
reads its tile ``(oi[s], oj[s])`` from a device int32 table at
``blockIdx.x``.  The table is built from ``repro_torch.core.zorder`` once
per ``(gm, gn, order, device)`` and cached on the device.  The k loop runs
inside the CTA with fp32 accumulators in registers; ragged edges are
masked in the kernel, so nothing is padded.  See the source note in the
``.cu`` file for the kernel's bound and what its design does about it.

``launches`` counts accepted launches; a run that resets it to 0 can show
that its products went through the kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.zorder import rowmajor_schedule, zorder_schedule

# Block shapes compiled into the library, (block_m, block_n, block_k) per
# input type: the first serves m > 16 (prefill), the second m <= 16 (decode
# at serving batch sizes).  The .cu file instantiates exactly these.
BLOCKS: Dict[torch.dtype, Tuple[Tuple[int, int, int], ...]] = {
    torch.bfloat16: ((64, 64, 32), (16, 64, 128)),
    torch.float32: ((64, 64, 16), (16, 64, 32)),
}
SMALL_M = 16
BF16_STAGES = 4
# A block may use 227 KB of the SM's shared memory (above 48 KB only as
# dynamic shared memory, which the launcher opts into).
SMEM_LIMIT = 227 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_tile_tables: Dict[Tuple[int, int, str, torch.device], torch.Tensor] = {}


def smem_bytes(block_m: int, block_n: int, block_k: int, dtype: torch.dtype) -> int:
    """Shared memory one CTA of the compiled kernel claims (mirrors the
    ``kSmemBytes`` of the tile structs in the .cu file)."""
    if dtype == torch.bfloat16:
        pipe = BF16_STAGES * (block_m * (block_k + 8) + block_k * (block_n + 8)) * 2
        return max(pipe, block_m * (block_n + 4) * 4)
    return block_k * ((block_m + 1) + (block_n + 1)) * 4


def default_blocks(m: int, n: int, k: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """The compiled block shape for an (m, k) x (k, n) product: a 16-row
    tile with a deep k step for decode-sized m, a 64 x 64 tile otherwise."""
    del n, k  # both tiles take any n and k; only m selects
    large, small = BLOCKS[dtype]
    return small if m <= SMALL_M else large


def tile_table(gm: int, gn: int, order: str, device: torch.device) -> torch.Tensor:
    """Device int32 table ``[oi..., oj...]`` of the output-tile visit
    order, uploaded once per (gm, gn, order, device)."""
    key = (gm, gn, order, device)
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


def zorder_matmul(a: torch.Tensor, b: torch.Tensor, *, block_m: int, block_n: int,
                  block_k: int, out_dtype: torch.dtype, order: str = "zorder") -> torch.Tensor:
    """Launch the kernel on CUDA tensors ``a`` (m, k) and ``b`` (k, n).

    The caller (``ops.matmul``) has checked device, type, shape, contiguity
    and blocks.  Launches on the current stream without synchronising;
    raises if the launch is refused (the C entry point also refuses block
    shapes it was not compiled for)."""
    global launches
    from ._build import load

    if a.device.type != "cuda":
        raise ValueError(f"zorder_matmul runs on CUDA tensors, got {a.device}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    gm, gn = -(-m // block_m), -(-n // block_n)
    tiles = tile_table(gm, gn, order, a.device)
    lib = load()
    rc = lib.zorder_matmul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), tiles.data_ptr(), gm * gn,
        m, n, k, _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype],
        block_m, block_n, block_k,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"zorder_matmul launch failed: "
                           f"{lib.zorder_matmul_error_string(rc).decode()} ({rc})")
    launches += 1
    return out
