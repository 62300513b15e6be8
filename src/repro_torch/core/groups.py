"""Finite groups, actions and the specific group families the paper uses.

The paper models
  * algorithm symmetry as the action of ``S_l x S_m x S_n`` on the instruction
    set ``X = {(i,j,k)}`` of classical matmul (Sec. 2.1),
  * machines as the action of a network group ``N`` times a time-increment
    group ``Delta`` on ``P x T`` (Sec. 2.2),
  * and builds schedules from homomorphisms between subgroups of these.

We implement exactly the group families needed to *compute* with the paper's
constructions: cyclic groups Z/nZ, direct products, permutations (with the
paper's primitive/imprimitive distinction from Lemmas 3-5), cyclic-shift
subgroups ``Sigma_q``, and iterated wreath products ``S2^{wr k}`` modelling
fat-trees.  Everything is small, exact integer math -- this layer is the
"solve algebraic equations" part of the paper, not a performance path.

Copy of ``repro.core.groups`` (standard library only), so the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, Sequence, Tuple


# ---------------------------------------------------------------------------
# Cyclic groups and products of them (abelian machine/network groups)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CyclicGroup:
    """Z/nZ with elements ``0..n-1`` under addition mod n."""

    n: int

    @property
    def identity(self) -> int:
        return 0

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.n

    def neg(self, a: int) -> int:
        return (-a) % self.n

    def mul(self, a: int, k: int) -> int:
        """k-fold repeated addition (integer scalar times element)."""
        return (a * k) % self.n

    def elements(self) -> range:
        return range(self.n)

    def order_of(self, a: int) -> int:
        return self.n // math.gcd(self.n, a % self.n) if a % self.n else 1

    def __len__(self) -> int:
        return self.n


@dataclasses.dataclass(frozen=True)
class ProductGroup:
    """Direct product of cyclic groups; elements are int tuples.

    Models e.g. the 2D-torus network group (Z/qZ)^2, the 3D torus
    (Z/qZ)^2 x Z/cZ of the 2.5D algorithm, and N x Delta.
    """

    moduli: Tuple[int, ...]

    @property
    def identity(self) -> Tuple[int, ...]:
        return tuple(0 for _ in self.moduli)

    def add(self, a: Sequence[int], b: Sequence[int]) -> Tuple[int, ...]:
        return tuple((x + y) % n for x, y, n in zip(a, b, self.moduli))

    def neg(self, a: Sequence[int]) -> Tuple[int, ...]:
        return tuple((-x) % n for x, n in zip(a, self.moduli))

    def mul(self, a: Sequence[int], k: int) -> Tuple[int, ...]:
        return tuple((x * k) % n for x, n in zip(a, self.moduli))

    def elements(self) -> Iterable[Tuple[int, ...]]:
        return itertools.product(*(range(n) for n in self.moduli))

    def order_of(self, a: Sequence[int]) -> int:
        orders = [
            (n // math.gcd(n, x % n)) if x % n else 1
            for x, n in zip(a, self.moduli)
        ]
        return math.lcm(*orders) if orders else 1

    def __len__(self) -> int:
        return math.prod(self.moduli)


# ---------------------------------------------------------------------------
# Permutations (subgroups of S_q; algorithm-symmetry side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Permutation:
    """A permutation of [q] as the tuple ``image`` with image[i] = sigma(i)."""

    image: Tuple[int, ...]

    @staticmethod
    def identity(q: int) -> "Permutation":
        return Permutation(tuple(range(q)))

    @staticmethod
    def cyclic_shift(q: int, step: int = 1) -> "Permutation":
        """The one-step shift sigma_-> : i -> i + step (mod q) of the paper."""
        return Permutation(tuple((i + step) % q for i in range(q)))

    @staticmethod
    def from_cycles(q: int, cycles: Sequence[Sequence[int]]) -> "Permutation":
        img = list(range(q))
        for cyc in cycles:
            for a, b in zip(cyc, cyc[1:] + type(cyc)([cyc[0]])):
                img[a] = b
        return Permutation(tuple(img))

    @property
    def q(self) -> int:
        return len(self.image)

    def __call__(self, i: int) -> int:
        return self.image[i]

    def compose(self, other: "Permutation") -> "Permutation":
        """(self o other)(i) = self(other(i))."""
        return Permutation(tuple(self.image[other.image[i]] for i in range(self.q)))

    def inverse(self) -> "Permutation":
        inv = [0] * self.q
        for i, v in enumerate(self.image):
            inv[v] = i
        return Permutation(tuple(inv))

    def power(self, k: int) -> "Permutation":
        if k < 0:
            return self.inverse().power(-k)
        out = Permutation.identity(self.q)
        base = self
        while k:
            if k & 1:
                out = out.compose(base)
            base = base.compose(base)
            k >>= 1
        return out

    def is_identity(self) -> bool:
        return all(v == i for i, v in enumerate(self.image))

    def cycle_type(self) -> Tuple[int, ...]:
        seen = [False] * self.q
        lens = []
        for i in range(self.q):
            if seen[i]:
                continue
            n, j = 0, i
            while not seen[j]:
                seen[j] = True
                j = self.image[j]
                n += 1
            lens.append(n)
        return tuple(sorted(lens, reverse=True))

    def order(self) -> int:
        return math.lcm(*self.cycle_type())

    def is_primitive(self) -> bool:
        """Paper's Sec. 4 notion: a permutation is *imprimitive* when its cycle
        decomposition splits [q] into non-trivial parts; primitive otherwise
        (single q-cycle). Used by Lemmas 3-5."""
        return self.cycle_type() == (self.q,)


def sigma_subgroup(q: int) -> list:
    """The transitive cyclic subgroup Sigma_q <= S_q generated by sigma_->.

    Sigma_q ~ Z/qZ; the paper builds all the torus schedules from it."""
    s = Permutation.cyclic_shift(q)
    out, cur = [], Permutation.identity(q)
    for _ in range(q):
        out.append(cur)
        cur = cur.compose(s)
    return out


# ---------------------------------------------------------------------------
# Iterated wreath product S2^{wr k}  (fat-tree network group, Sec. 2.5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WreathTreeElement:
    """An element of S2^{wr k} acting on 2^k leaves.

    Represented by one swap-bit per internal node of the complete binary tree
    (levels 1..k, level k = root).  ``swaps[l]`` is a tuple of 2^(k-l) bits for
    level l: bit b says "swap the two children of the b-th node at level l".
    The action on a leaf applies level-k (root) first, then descends; this is
    exactly the paper's "at each internal node ... choose to swap the left and
    right subtree" description.
    """

    k: int
    swaps: Tuple[Tuple[int, ...], ...]  # swaps[l-1] has 2^(k-l) entries

    @staticmethod
    def identity(k: int) -> "WreathTreeElement":
        return WreathTreeElement(
            k, tuple(tuple(0 for _ in range(2 ** (k - l))) for l in range(1, k + 1))
        )

    @staticmethod
    def level_swap(k: int, level: int, node: int) -> "WreathTreeElement":
        """Generator: swap the children of ``node`` at ``level`` (1-based)."""
        sw = [list((0,) * (2 ** (k - l))) for l in range(1, k + 1)]
        sw[level - 1][node] = 1
        return WreathTreeElement(k, tuple(tuple(row) for row in sw))

    def apply(self, leaf: int) -> int:
        """Image of a leaf index in [2^k] under this element."""
        # Walk from root down; at level l the current node index is the top
        # (k-l) bits of the (partially permuted) leaf index.
        x = leaf
        for l in range(self.k, 0, -1):
            node = x >> l  # index of the level-l node containing x
            if self.swaps[l - 1][node]:
                x ^= 1 << (l - 1)  # swap the two subtrees: flip bit l-1
        return x

    def compose(self, other: "WreathTreeElement") -> "WreathTreeElement":
        """self o other via action composition (exact, by tabulation)."""
        assert self.k == other.k
        n = 2 ** self.k
        table = [self.apply(other.apply(i)) for i in range(n)]
        return WreathTreeElement.from_table(self.k, tuple(table))

    @staticmethod
    def from_table(k: int, table: Tuple[int, ...]) -> "WreathTreeElement":
        """Reconstruct the swap-bit representation from a permutation table
        that is promised to lie in S2^{wr k}."""
        table = list(table)
        swaps = []
        # Peel from the root down: at level l, node b is swapped iff the
        # current table maps its left half into the right half.
        for l in range(k, 0, -1):
            row = []
            for b in range(2 ** (k - l)):
                base = b << l
                # Node b is swapped iff its left half [base, base+2^(l-1))
                # lands in the right half under the (residual) map.
                lo = table[base]
                row.append(1 if ((lo >> (l - 1)) & 1) != ((base >> (l - 1)) & 1) else 0)
            # normalize: row computed w.r.t. original positions; apply it
            # to the table so lower levels see the residual permutation.
            new_table = list(table)
            if any(row):
                for i in range(2 ** k):
                    node = i >> l
                    if row[node]:
                        new_table[i ^ (1 << (l - 1))] = table[i]
                table = new_table
            swaps.append(tuple(row))
        swaps.reverse()  # stored level-1-first
        return WreathTreeElement(k, tuple(swaps))

    def is_identity(self) -> bool:
        return all(all(b == 0 for b in row) for row in self.swaps)


def fat_tree_group_size(k: int) -> int:
    """|S2^{wr k}| = 2^(2^k - 1) (paper Sec. 2.5 notes 2^(n-1) elements)."""
    return 2 ** (2 ** k - 1)


# ---------------------------------------------------------------------------
# Hexagonal VLSI lattice group (Sec. D.2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HexLattice:
    """The free abelian group <g1,g2,g3 | g1 = g2 g3> acting on the hex array.

    We coordinatize with basis (g2, g3) so g2=(1,0), g3=(0,1), g1=(1,1);
    elements are integer 2-vectors, the action is translation.  Each of the
    three generators corresponds to one of the three link directions of the
    hexagonal multiply-accumulate array of Kung [24].
    """

    g1: Tuple[int, int] = (1, 1)
    g2: Tuple[int, int] = (1, 0)
    g3: Tuple[int, int] = (0, 1)

    def translate(self, node: Tuple[int, int], vec: Tuple[int, int]) -> Tuple[int, int]:
        return (node[0] + vec[0], node[1] + vec[1])

    def combine(self, a2: int, a3: int) -> Tuple[int, int]:
        """a2*g2 + a3*g3."""
        return (a2 * self.g2[0] + a3 * self.g3[0], a2 * self.g2[1] + a3 * self.g3[1])

    @staticmethod
    def link_hops(vec: Tuple[int, int]) -> int:
        """Minimal number of single-link moves realizing translation ``vec``.

        Links are +-g1, +-g2, +-g3 with g1 = g2+g3; the hex-lattice word
        metric is |x|+|y| when x,y have opposite signs, max(|x|,|y|) when the
        same sign (diagonal g1 moves cover both)."""
        x, y = vec
        if (x >= 0) == (y >= 0):
            return max(abs(x), abs(y))
        return abs(x) + abs(y)
