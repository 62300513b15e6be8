"""Z-order (Morton) traversals of a block grid, the paper's Sec. 4.3 schedule.

The port's own copy of ``repro.core.zorder``'s traversal functions (the
port imports nothing of ``repro``).  The space-bounded schedule lifts
low-order index bits to small time steps: a Morton traversal of the
(i, j, k) block index space.  On Hopper the (i, j) order of output tiles
becomes the CTA numbering of the matmul kernel
(``repro_torch.kernels.matmul``).
"""
from __future__ import annotations

import math
from typing import List, Tuple


def morton_decode3(code: int) -> Tuple[int, int, int]:
    """De-interleave bits code -> (i, j, k); bit 0 -> k, bit 1 -> j, bit 2 -> i."""
    i = j = k = 0
    bit = 0
    while code:
        k |= (code & 1) << bit
        j |= ((code >> 1) & 1) << bit
        i |= ((code >> 2) & 1) << bit
        code >>= 3
        bit += 1
    return i, j, k


def morton_encode3(i: int, j: int, k: int) -> int:
    """Inverse of ``morton_decode3``."""
    out = 0
    bit = 0
    while i or j or k:
        out |= (k & 1) << (3 * bit)
        out |= (j & 1) << (3 * bit + 1)
        out |= (i & 1) << (3 * bit + 2)
        i >>= 1
        j >>= 1
        k >>= 1
        bit += 1
    return out


def enclosing_pow2(n: int) -> int:
    """Smallest power of two >= n (the side of the enclosing Morton cube)."""
    return 1 if n <= 1 else 2 ** math.ceil(math.log2(n))


def zorder_schedule(gi: int, gj: int, gk: int) -> List[Tuple[int, int, int]]:
    """Z-order traversal of a (gi, gj, gk) block grid.

    The same order as ``repro.core.zorder.zorder_schedule``, which walks
    every code of the enclosing power-of-two cube and keeps those inside
    the grid.  Sorting the grid's own cells by their code gives that order
    without visiting the cube: O(n log n) in the cells, where the cube walk
    costs ``enclosing_pow2(max(gi, gj, gk)) ** 3`` (2M codes for a 1 x 128
    tile grid)."""
    cells = [(i, j, k) for i in range(gi) for j in range(gj) for k in range(gk)]
    return sorted(cells, key=lambda c: morton_encode3(*c))


def rowmajor_schedule(gi: int, gj: int, gk: int) -> List[Tuple[int, int, int]]:
    return [(i, j, k) for i in range(gi) for j in range(gj) for k in range(gk)]
