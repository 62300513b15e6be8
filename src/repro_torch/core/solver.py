"""Solving the commutative diagrams for schedules (Sec. 3 + Sec. 4.1).

The paper's procedure:
  1. pick a subgroup of the symmetry group (here Sigma_q^3, the cyclic-shift
     subgroup -- Lemma 4 says for prime q it is the only source of
     non-trivial homomorphisms to Z/qZ),
  2. enumerate homomorphisms rho to N x Delta by generator images,
  3. solve the commutative diagram (embedding + data-movement consistency),
  4. keep the minimum-cost solutions.

``solve_torus`` does exactly this for the q x q torus: it enumerates the
3 x 3 generator-image matrices with entries in a small window (one-hop
movement can only arise from +-1/0 images -- larger entries cost more hops,
monotonically, so the window is exact for finding *minimal* solutions),
filters by embedding + diagram solvability, and ranks by total hop cost.
Cannon and its unimodular variants fall out as the cost-2 family.

Copy of ``repro.core.solver`` over the port's own ``core.schedule``, so the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

from .schedule import TorusSchedule, torus_hops


@dataclasses.dataclass(frozen=True)
class Solution:
    schedule: TorusSchedule
    hop_cost: int
    movements: Tuple[Tuple[str, Tuple[int, int]], ...]

    @property
    def stationary_vars(self) -> Tuple[str, ...]:
        return tuple(v for v, mv in self.movements if mv == (0, 0))


def solve_torus(
    q: int,
    window: Sequence[int] = (-1, 0, 1),
    max_solutions: Optional[int] = None,
    require_stationary: Optional[str] = None,
) -> List[Solution]:
    """Enumerate valid schedules for the q x q torus, sorted by hop cost.

    window: candidate values (mod q) for each entry of M.  (-1,0,1) suffices
    to find all one-hop-per-step schedules; widen to audit costlier ones.
    """
    sols: List[Solution] = []
    seen_M = set()
    for rows in itertools.product(itertools.product(window, repeat=3), repeat=3):
        M = tuple(tuple(int(v) % q for v in row) for row in rows)
        if M in seen_M:
            continue
        seen_M.add(M)
        sched = TorusSchedule(q=q, t=q, M=M)
        if not sched.is_embedding():
            continue
        moves = sched.movements()
        if moves is None:
            continue
        if require_stationary and moves[require_stationary] != (0, 0):
            continue
        cost = sum(torus_hops(mv, q) for mv in moves.values())
        # full validation (placement bijectivity) only for survivors
        if not sched.validate():
            continue
        sols.append(
            Solution(
                schedule=sched,
                hop_cost=cost,
                movements=tuple(sorted(moves.items())),
            )
        )
    sols.sort(key=lambda s: (s.hop_cost, s.schedule.M))
    if max_solutions is not None:
        sols = sols[:max_solutions]
    return sols


def minimal_hop_cost(q: int) -> int:
    """The minimum total per-step hop cost over valid schedules.

    The paper (Sec. 4.1): "the movement cost factor determined by mu can be 0
    for at most one of [A, B, C]" -- so the minimum is 2 (two variables each
    moving one hop, one stationary), which Cannon attains.
    """
    sols = solve_torus(q)
    return sols[0].hop_cost if sols else -1


def is_cannon_like(sol: Solution) -> bool:
    """Cost-2 with exactly one stationary variable and two one-hop movers."""
    hops = [torus_hops(mv, sol.schedule.q) for _, mv in sol.movements]
    return sorted(hops) == [0, 1, 1]


def at_most_one_stationary(q: int) -> bool:
    """Executable form of the paper's claim: no valid schedule keeps two of
    A, B, C stationary (their movement homomorphisms cannot both vanish)."""
    for rows in itertools.product(itertools.product((-1, 0, 1), repeat=3), repeat=3):
        sched = TorusSchedule(q=q, t=q, M=tuple(tuple(v % q for v in r) for r in rows))
        if not sched.is_embedding():
            continue
        moves = sched.movements()
        if moves is None:
            continue
        if sum(1 for mv in moves.values() if mv == (0, 0)) > 1:
            return False
    return True
