"""Recursive fat-tree schedules (Sec. 4.2) from the iterated wreath product.

Copy of ``repro.core.fattree`` (pure Python), so the port imports nothing
of the JAX package.

The base case (Fig. 11): 2x2x2 multiply on 4 processors over 2 steps, with
generators sigma_i, sigma_j, sigma_k mapping onto the fat-tree group
S2^{wr 2} x Z/2Z so that

    processor bits = (k, i)          (C_ki stationary)
    time bit       = i xor j xor k   (each processor runs its two
                                      instructions at distinct steps)

A's position's *high* bit flips every step (crosses the top-level link) and
B's *low* bit flips every step (crosses leaf-level links) -- the minimum
communication for three-words-per-node memory (paper: 4 words over the top
link, 8 over the lower links, counting path segments).

The d-level schedule composes the base case per bit level (the wreath
recursion of Sec. 4.2): processor bits interleave (k_l, i_l) from the top,
and each level contributes an independent time bit tau_l = i_l ^ j_l ^ k_l.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple


def tree_exchange_mask(t: int) -> int:
    """XOR mask of the inter-pod exchange between super-steps t and t+1.

    The recursive schedule walks contraction slabs in the reflected-Gray
    order j = p ^ t, so the slab resident on pod p advances by
    ``t ^ (t + 1)`` -- always of the form 2^(b+1) - 1 where b is the number
    of trailing one-bits of t.  The mask's highest bit is the deepest tree
    level the exchange crosses; the root (level log2(s)) is crossed exactly
    once, at t = s/2 - 1."""
    return t ^ (t + 1)


def tree_exchange_perm(s: int, t: int) -> Tuple[Tuple[int, int], ...]:
    """The pod-axis ppermute realizing the exchange after super-step t: the
    XOR-mask involution d -> d ^ mask on the s pods (pairs swap, so the
    permutation is its own inverse -- every pod both sends and receives its
    A slab shard in one round)."""
    mask = tree_exchange_mask(t)
    return tuple((d, d ^ mask) for d in range(s))


@dataclasses.dataclass(frozen=True)
class FatTreeSchedule:
    """Schedule for n x n x n multiply, n = 2^d, on a fat-tree with n^2 leaves.

    f(i, j, k) -> (processor in [4^d], time in [2^d]); each processor holds
    one element of each of A, B, C at any step (3 words of memory)."""

    d: int

    @property
    def n(self) -> int:
        return 1 << self.d

    @property
    def num_procs(self) -> int:
        return 1 << (2 * self.d)

    @property
    def num_steps(self) -> int:
        return 1 << self.d

    def f(self, i: int, j: int, k: int) -> Tuple[int, int]:
        proc = 0
        time = 0
        for l in range(self.d - 1, -1, -1):
            il, jl, kl = (i >> l) & 1, (j >> l) & 1, (k >> l) & 1
            proc = (proc << 2) | (kl << 1) | il
            time = (time << 1) | (il ^ jl ^ kl)
        return proc, time

    # positions of variable elements at a given step ------------------------
    def pos_A(self, i: int, j: int, time: int) -> int:
        """Processor holding A_ij at ``time``: the k solving tau_l for each
        level is k_l = i_l ^ j_l ^ tau_l."""
        proc = 0
        for l in range(self.d - 1, -1, -1):
            il, jl, tl = (i >> l) & 1, (j >> l) & 1, (time >> l) & 1
            kl = il ^ jl ^ tl
            proc = (proc << 2) | (kl << 1) | il
        return proc

    def pos_B(self, j: int, k: int, time: int) -> int:
        proc = 0
        for l in range(self.d - 1, -1, -1):
            jl, kl, tl = (j >> l) & 1, (k >> l) & 1, (time >> l) & 1
            il = jl ^ kl ^ tl
            proc = (proc << 2) | (kl << 1) | il
        return proc

    def pos_C(self, k: int, i: int) -> int:
        proc = 0
        for l in range(self.d - 1, -1, -1):
            il, kl = (i >> l) & 1, (k >> l) & 1
            proc = (proc << 2) | (kl << 1) | il
        return proc

    # communication accounting ----------------------------------------------
    @functools.cached_property
    def _link_traffic(self) -> Dict[int, int]:
        """The O(n^3 . steps) traffic sweep, computed once per schedule
        (``link_traffic``/``top_level_words``/``level_words`` all read this
        cache; d=3 conformance sweeps assert against it repeatedly)."""
        traffic = {lvl: 0 for lvl in range(1, 2 * self.d + 1)}
        n = self.n
        for time in range(self.num_steps - 1):
            for a in range(n):
                for b in range(n):
                    for (src, dst) in (
                        (self.pos_A(a, b, time), self.pos_A(a, b, time + 1)),
                        (self.pos_B(a, b, time), self.pos_B(a, b, time + 1)),
                    ):
                        if src == dst:
                            continue
                        top = (src ^ dst).bit_length()  # highest differing bit+1
                        for lvl in range(1, top + 1):
                            # a message transits 2 links (up + down) at every
                            # level of its path, including the turning level
                            traffic[lvl] += 2
        return traffic

    def link_traffic(self) -> Dict[int, int]:
        """Words crossing links at each fat-tree level, summed over the run.

        Level L (1 = leaf links, 2d = top) is crossed by a message whose
        source and destination processors first differ at bit (L-1); a
        message crossing level L transits 2 links at every level <= L on its
        up-and-down path; we count *words x links* per level, matching the
        paper's per-level accounting.  Returns a fresh dict; the sweep is
        cached per schedule."""
        return dict(self._link_traffic)

    def level_words(self, level: int) -> int:
        """Words (not words x links) crossing ``level`` over the whole run:
        each word transits 2 links at every level of its path, so the word
        count is half the per-level link traffic."""
        return self._link_traffic[level] // 2

    def top_level_words(self) -> int:
        """Words of A+B crossing the top-level (2d) link over the whole run;
        the paper's claim: n^2 for A (and none for B or C)."""
        return self.level_words(2 * self.d)

    def validate(self) -> bool:
        """Injectivity of f and the 3-words memory bound."""
        n = self.n
        seen = set()
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    key = self.f(i, j, k)
                    if key in seen:
                        return False
                    seen.add(key)
        # every (proc, time) cell used exactly once
        return len(seen) == n ** 3 and n ** 3 == self.num_procs * self.num_steps
