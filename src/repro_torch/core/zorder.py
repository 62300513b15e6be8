"""Space-bounded schedules as Z-order traversals, the paper's Sec. 4.3.

The port's own copy of ``repro.core.zorder`` (the port imports nothing of
``repro``).  The space-bounded schedule lifts low-order index bits to small
time steps: a Morton traversal of the (i, j, k) block index space, which
runs the largest sub-multiplication that fits each cache level whole.  The
module holds

* the traversals: ``zorder_schedule`` and the naive ``rowmajor_schedule``
  (and the Morton code they rest on);
* the traffic model: ``block_reuse_distance_traffic`` counts a traversal's
  block fetches through an LRU cache of M blocks, ``ideal_traffic`` is the
  O(steps / sqrt(M)) bound Z-order meets at every level (cache-oblivious,
  Frigo et al. [16]) and row-major does not;
* the supersteps: ``supersteps`` cuts the Z-order into the sub-products of
  the multi-granularity time T = T_1 x ... x T_k.

Where the port uses the order: K1's ``tile_table``
(``repro_torch.kernels.matmul.kernel``) turns the (i, j) order of output
tiles into the order in which the persistent CTAs of the Hopper kernel
take them, which governs their reuse of the L2.
``zorder_grid_index_map`` is the reference's Pallas ``index_map`` form of
the same table, kept for parity.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Iterator, List, Tuple


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


def block_reuse_distance_traffic(order: List[Tuple[int, int, int]], cache_blocks: int) -> int:
    """LRU-model traffic: the (variable, block) fetches that miss an LRU
    cache of ``cache_blocks`` blocks, where step (i, j, k) touches the
    blocks A(i, j), B(j, k) and C(i, k).

    This is the machine side of Sec. 4.3: the space-bounded schedule's
    traffic at a level of M blocks is O(#steps / sqrt(M)) block fetches."""
    lru: "OrderedDict[Tuple[str, int, int], None]" = OrderedDict()
    misses = 0
    for (i, j, k) in order:
        for key in (("A", i, j), ("B", j, k), ("C", i, k)):
            if key in lru:
                lru.move_to_end(key)
            else:
                misses += 1
                lru[key] = None
                if len(lru) > cache_blocks:
                    lru.popitem(last=False)
    return misses


def ideal_traffic(num_steps: int, cache_blocks: int) -> float:
    """The O(steps / sqrt(M)) transfer bound (blocks) of a matmul at cache
    size M, with the reference's constant."""
    return 3.0 * num_steps / math.sqrt(max(cache_blocks // 3, 1))


def zorder_grid_index_map(gi: int, gj: int, gk: int) -> Callable[[int], Tuple[int, int, int]]:
    """``index_map(step) -> (i, j, k)`` of a 1-D grid of ``gi * gj * gk``
    steps taken in Z-order: a lookup in the precomputed order."""
    order = zorder_schedule(gi, gj, gk)
    return lambda s: order[s]


def supersteps(gi: int, gj: int, gk: int,
               level_bits: int) -> Iterator[List[Tuple[int, int, int]]]:
    """The Z-order traversal cut into supersteps of ``8 ** level_bits``
    blocks (the paper's T = T_1 x ... x T_k); each is a sub-multiplication
    that fits one cache level."""
    order = zorder_schedule(gi, gj, gk)
    size = 8 ** level_bits
    for s in range(0, len(order), size):
        yield order[s:s + size]
