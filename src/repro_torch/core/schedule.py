"""Equivariant torus schedules for classical matrix multiplication (Sec. 4.1).

Copy of ``repro.core.schedule`` (numpy only), so the port imports nothing
of the JAX package.

A schedule on a q x q torus over t time steps is the equivariant map

    f(X_ijk) = (x0 + i*x1 + j*x2 + k*x3,
                y0 + i*y1 + j*y2 + k*y3,
                t0 + i*t1 + j*t2 + k*t3)        (mod q, q, t)

fixed by the homomorphism generator images M = [[x1,y1,t1],
                                                [x2,y2,t2],
                                                [x3,y3,t3]]  and an anchor.

Each variable set (A on (i,j), B on (j,k), C on (k,i)) moves by a constant
network element mu = (mu_x, mu_y) per time step; the commutative diagram of
Fig. 10 forces, for the *absent* index a of the variable set,

    (x_a, y_a) = t_a * (mu_x, mu_y)      (mod q)

and the initial layout (the paper's l_I at t=t0) is then determined -- for
Cannon this reproduces the classic skewed layout.  ``TorusSchedule`` checks
embedding/injectivity (the image of rho must have full size q^2*t restricted
to the instruction orbit), derives the movement homomorphisms, placements,
and exposes per-step movement vectors consumed by ``repro_torch.dist``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

VarName = str  # "A" | "B" | "C"

# index positions: i=0, j=1, k=2.  Variable -> (present indices, absent index)
VAR_INDEX = {
    "A": ((0, 1), 2),  # A_ij, absent k
    "B": ((1, 2), 0),  # B_jk, absent i
    "C": ((2, 0), 1),  # C_ki, absent j
}


def _inv_mod(a: int, q: int) -> Optional[int]:
    a %= q
    if math.gcd(a, q) != 1:
        return None
    return pow(a, -1, q)


@dataclasses.dataclass(frozen=True)
class TorusSchedule:
    """A candidate schedule; rows of M are the images of the i/j/k shifts."""

    q: int
    t: int
    M: Tuple[Tuple[int, int, int], ...]  # 3 rows of (x, y, tau)
    anchor: Tuple[int, int, int] = (0, 0, 0)

    # -- the equivariant map f ---------------------------------------------
    def f(self, i: int, j: int, k: int) -> Tuple[int, int, int]:
        x0, y0, t0 = self.anchor
        (x1, y1, t1), (x2, y2, t2), (x3, y3, t3) = self.M
        return (
            (x0 + i * x1 + j * x2 + k * x3) % self.q,
            (y0 + i * y1 + j * y2 + k * y3) % self.q,
            (t0 + i * t1 + j * t2 + k * t3) % self.t,
        )

    # -- embedding / injectivity (Sec. 4.1 "image of rho at least q^3") -----
    def is_embedding(self) -> bool:
        """f must be injective on [q]^3 (at most one instruction per
        processor per step, three memory words per node)."""
        if self.t % self.q != 0:
            return False  # Lemma 5
        if self.t == self.q:
            # Linear map Z_q^3 -> Z_q^3: injective iff det invertible mod q.
            (a, b, c), (d, e, f_), (g, h, i_) = self.M
            det = a * (e * i_ - f_ * h) - b * (d * i_ - f_ * g) + c * (d * h - e * g)
            return math.gcd(det % self.q, self.q) == 1
        # general t: brute force (only used for small q in tests)
        seen = set()
        for i in range(self.q):
            for j in range(self.q):
                for k in range(self.q):
                    p = self.f(i, j, k)
                    if p in seen:
                        return False
                    seen.add(p)
        return True

    # -- movement homomorphisms mu per variable set (Fig. 10 constraint) ----
    def movement(self, var: VarName) -> Optional[Tuple[int, int]]:
        """(mu_x, mu_y) network element moving ``var`` each time step, or
        None when the commutative diagram has no solution (schedule invalid
        for this variable set)."""
        _, absent = VAR_INDEX[var]
        xa, ya, ta = self.M[absent]
        tinv = _inv_mod(ta, self.q)
        if tinv is None:
            # t_a not invertible: need (x_a, y_a) == 0 as well, and then the
            # variable would be needed at 2+ places at the same step => only
            # consistent if it never moves AND placement is replicated; the
            # single-copy model forbids that unless (x_a,y_a)=(0,0)=t_a.
            if (xa % self.q, ya % self.q) == (0, 0) and ta % self.t == 0:
                return (0, 0)
            return None
        return ((xa * tinv) % self.q, (ya * tinv) % self.q)

    def movements(self) -> Optional[Dict[VarName, Tuple[int, int]]]:
        out = {}
        for v in ("A", "B", "C"):
            mv = self.movement(v)
            if mv is None:
                return None
            out[v] = mv
        return out

    # -- initial data placement l_I at time t0 ------------------------------
    def placement(self, var: VarName) -> Optional[np.ndarray]:
        """q x q array: placement[r, s] = (x, y) of variable element (r, s)
        at the anchor time step t0.  Solves f's time row for the absent index
        such that the instruction touching (r,s) runs at t0."""
        if self.t != self.q:
            return None  # placements only materialized for the t = q family
        (p0, p1), absent = VAR_INDEX[var]
        _, _, ta = self.M[absent]
        tinv = _inv_mod(ta, self.q)
        if tinv is None:
            return None
        x0, y0, t0 = self.anchor
        out = np.zeros((self.q, self.q, 2), dtype=np.int64)
        for r in range(self.q):
            for s in range(self.q):
                idx = [0, 0, 0]
                idx[p0], idx[p1] = r, s
                # residual time owed to the two present indices
                tpart = (idx[0] * self.M[0][2] + idx[1] * self.M[1][2]
                         + idx[2] * self.M[2][2])
                # solve t0 + tpart + a*ta == t0  (mod q)  for absent exponent a
                a = (-tpart * tinv) % self.q
                idx[absent] = a
                x, y, _ = self.f(*idx)
                out[r, s] = (x, y)
        return out

    # -- lowering hooks consumed by repro_torch.dist ------------------------
    # A torus device (x, y) flattens to x * q + y -- row-major with the first
    # mesh axis major, as ``repro_torch.dist.mesh.Mesh`` numbers ranks over an
    # ("x", "y") axis tuple (and as jax.lax.ppermute does in the reference).
    # "Canonical" layout is the matrix-block layout under PartitionSpec(x, y):
    # A_ij at (i, j) and B_jk at (j, k) match their paper coordinates (r, s),
    # but the output C is indexed (k, i) in the paper while its matrix block
    # row is i -- so C's canonical device is the swap (s, r).

    def _canonical_device(self, var: VarName, r: int, s: int) -> Tuple[int, int]:
        return (s, r) if var == "C" else (r, s)

    def movement_perm(self, var: VarName) -> Optional[list]:
        """(src, dst) flat-device pairs for ONE time step of ``var``: the
        block on node nu moves to nu + mu.  This is the literal ``perm``
        argument repro_torch.dist feeds to ppermute each step."""
        mv = self.movement(var)
        if mv is None:
            return None
        mx, my = mv
        q = self.q
        return [
            (x * q + y, ((x + mx) % q) * q + (y + my) % q)
            for x in range(q)
            for y in range(q)
        ]

    def placement_perm(self, var: VarName) -> Optional[list]:
        """(src, dst) flat-device pairs taking the canonical block layout
        (block (r, s) on device (r, s), i.e. PartitionSpec(x, y)) to the
        schedule's initial placement l_I -- Cannon's skew, executed as a
        single ppermute over the flattened (x, y) axes."""
        pl = self.placement(var)
        if pl is None:
            return None
        q = self.q
        pairs = []
        for r in range(q):
            for s in range(q):
                cx, cy = self._canonical_device(var, r, s)
                pairs.append((cx * q + cy, int(pl[r, s, 0]) * q + int(pl[r, s, 1])))
        return pairs

    def collection_perm(self, var: VarName, after_steps: int) -> Optional[list]:
        """Inverse layout ppermute: (src, dst) pairs returning ``var`` from
        its position after ``after_steps`` movement steps back to the
        canonical block layout.  Identity perms are returned as [] so the
        executor can skip the collective."""
        pl = self.placement(var)
        mv = self.movement(var)
        if pl is None or mv is None:
            return None
        q = self.q
        pairs = []
        identity = True
        for r in range(q):
            for s in range(q):
                x = (int(pl[r, s, 0]) + after_steps * mv[0]) % q
                y = (int(pl[r, s, 1]) + after_steps * mv[1]) % q
                cx, cy = self._canonical_device(var, r, s)
                if (x, y) != (cx, cy):
                    identity = False
                pairs.append((x * q + y, cx * q + cy))
        return [] if identity else pairs

    # -- cost hooks ----------------------------------------------------------
    def hop_cost(self, var: VarName) -> Optional[int]:
        mv = self.movement(var)
        if mv is None:
            return None
        return torus_hops(mv, self.q)

    def total_hop_cost(self) -> Optional[int]:
        """Sum over A,B,C of per-step hop counts (the solver's objective)."""
        tot = 0
        for v in ("A", "B", "C"):
            h = self.hop_cost(v)
            if h is None:
                return None
            tot += h
        return tot

    def validate(self) -> bool:
        """Full validity: embedding + all three diagrams solvable + every
        processor touches exactly one C element (single-copy memory)."""
        if not self.is_embedding():
            return False
        if self.movements() is None:
            return False
        for v in ("A", "B", "C"):
            pl = self.placement(v)
            if pl is None:
                return False
            # single copy: placement must be a bijection onto the torus
            flat = {tuple(p) for row in pl for p in row}
            if len(flat) != self.q * self.q:
                return False
        return True


def torus_hops(vec: Tuple[int, int], q: int) -> int:
    """Minimal hop count of a torus translation (wrap-around metric)."""
    dx, dy = vec[0] % q, vec[1] % q
    return min(dx, q - dx) + min(dy, q - dy)


# ---------------------------------------------------------------------------
# Equivariance predicates on lowered (src, dst) device permutations.
#
# These are the machine-checkable halves of the paper's algebra, consumed by
# the reference's ``repro.verify.conformance``: a ppermute emitted by an equivariant schedule
# must be (a) a bijection on the torus and (b) a *translation* -- the image
# of the movement homomorphism mu commutes with the torus action, so every
# (src, dst) pair realizes the same network element.
# ---------------------------------------------------------------------------


def perm_is_bijection(perm, size: int) -> bool:
    """``perm`` (pairs of flat device ids, identity pairs may be elided)
    extends to a bijection on [size]: listed sources and destinations are
    distinct and within range."""
    perm = tuple(perm)
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        return False
    if any(not (0 <= v < size) for v in srcs + dsts):
        return False
    # elided identity pairs must not collide with listed endpoints
    elided = set(range(size)) - set(srcs)
    return elided == set(range(size)) - set(dsts)


def perm_translation(perm, q: int) -> Optional[Tuple[int, int]]:
    """The constant torus translation mu realized by ``perm`` over the
    flattened q x q torus (flat id = x * q + y), or None when the pairs do
    not share one -- i.e. the permutation is NOT the image of a movement
    homomorphism and the schedule's commutative diagram is violated."""
    perm = tuple(perm)
    mu = None
    for src, dst in perm:
        sx, sy = divmod(int(src), q)
        dx, dy = divmod(int(dst), q)
        step = ((dx - sx) % q, (dy - sy) % q)
        if mu is None:
            mu = step
        elif step != mu:
            return None
    # identity pairs elided from the listing are only consistent with mu = 0
    if mu is not None and mu != (0, 0) and len(perm) != q * q:
        return None
    return mu if mu is not None else (0, 0)


def movement_equations_hold(sched: TorusSchedule,
                            moves: Optional[Dict[VarName, Tuple[int, int]]]
                            = None) -> bool:
    """Fig.-10 commutative diagram: each variable set's per-step network
    element mu must satisfy (x_a, y_a) == t_a * mu (mod q) for the absent
    index a.  ``moves`` are the movement vectors to test -- pass the mus
    recovered from an *executed* program's permutations to verify it
    against the schedule's algebra (the discriminating use; with the
    schedule's own derived movements the equations hold by construction
    whenever they are solvable)."""
    if moves is None:
        moves = sched.movements()
    if moves is None:
        return False
    for var in ("A", "B", "C"):
        if var not in moves:
            return False
        mx, my = moves[var]
        _, absent = VAR_INDEX[var]
        xa, ya, ta = sched.M[absent]
        if (ta * mx - xa) % sched.q or (ta * my - ya) % sched.q:
            return False
    return True


def cannon_schedule(q: int) -> TorusSchedule:
    """The classical Cannon solution recovered in Sec. 4.1.

    C_ki stationary at P_{i,k}; time advances with every index; A moves one
    hop in -y, B one hop in -x per step; the induced initial placement is the
    classic skew  A_ij -> P_{i, j-i},  B_jk -> P_{j-k, k}.
    """
    return TorusSchedule(
        q=q,
        t=q,
        M=(
            (1, 0, -1 % q),  # image of i-shift
            (0, 0, 1),       # image of j-shift (contraction advances time)
            (0, 1, -1 % q),  # image of k-shift
        ),
    )


# ---------------------------------------------------------------------------
# 2.5D schedule on the q x q x c torus (Sec. D.1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Torus25DSchedule:
    """Equivariant schedule for the (Z/qZ)^2 x Z/cZ network of Sec. D.1.

    The contraction index j is split j = j_c * (q/c) + j_t; the c-part maps to
    the z axis (g_z) -- each of the c layers owns a contraction slab and a
    full copy of A and B (c-fold replication, Sec. 2.5) -- while the t-parts
    run a skewed Cannon inside each q x q layer for t = q/c steps.  C is
    computed as partial sums per layer and reduced over z at the end ("a
    suitable replication at the beginning and a reduction of C at the end").
    """

    q: int
    c: int

    def __post_init__(self):
        assert self.q % self.c == 0

    @property
    def t(self) -> int:
        return self.q // self.c

    def f(self, i: int, j: int, k: int) -> Tuple[int, int, int, int]:
        """(x, y, z, step) for the blocked instruction (i, j, k) in [q]^2x[q].

        Uses the rho' of Sec. D.1: i_t -> (g_x, -dt); j_t -> (e, dt);
        k_t -> (g_y, -dt); j_c -> g_z; i_c, k_c -> identity (they only select
        blocks within a node).
        """
        jc, jt = divmod(j, self.t)
        x = i % self.q
        y = k % self.q
        z = jc % self.c
        step = (jt - i - k) % self.t
        return (x, y, z, step)

    def layer_contraction_slab(self, z: int) -> Tuple[int, int]:
        """[lo, hi) of contraction indices owned by layer z."""
        return (z * self.t, (z + 1) * self.t)

    def replication_factor(self) -> int:
        return self.c

    def comm_words_per_node(self, n: int, p: int) -> float:
        """Analytic per-node communication of the 2.5D schedule for an
        n x n x n multiply on p = q*q*c nodes: O(n^2 / sqrt(c*p)) words
        moved per node during the Cannon phase, plus the c-fold replication
        broadcast and final reduction (n^2/p words each, amortized)."""
        q = self.q
        t = self.t
        block = (n / q) ** 2  # words per block per variable
        shift_words = 2 * block * max(t - 1, 0)  # A and B one-hop shifts
        repl_words = 2 * block * (self.c - 1) / self.c  # initial broadcast
        reduce_words = block * (self.c - 1) / self.c  # C reduction over z
        return shift_words + repl_words + reduce_words
