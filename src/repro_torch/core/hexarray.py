"""Hexagonal VLSI systolic schedule (Sec. D.2, Kung [24]) + simulator.

The network group is the free abelian group <g1,g2,g3 | g1 = g2*g3> acting on
the infinite hex lattice; with basis (g2, g3) nodes are integer pairs.  The
homomorphism of Sec. D.2,

    rho(sigma_i) = ( g2, dt)      A-streams flow along +g2
    rho(sigma_j) = (-g1, dt)      B... (j advances the C anti-stream -g1)
    rho(sigma_k) = ( g3, dt)      ... along +g3

with Delta = Z/3qZ gives the systolic schedule f(i,j,k) =
(i*g2 - j*g1 + k*g3, i+j+k).  No card offers a hex array to program (a
GPU's tensor cores are fixed-function), so this module is a faithful
algebraic simulator in numpy: it checks the systolic
properties (<=1 MAC per node per step; each variable moves one fixed link per
step -- Kung's "direction, speed and timing") and that the computed C matches.

Copy of ``repro.core.hexarray`` (numpy only), so the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .groups import HexLattice


@dataclasses.dataclass(frozen=True)
class HexSchedule:
    q: int
    lattice: HexLattice = HexLattice()

    def f(self, i: int, j: int, k: int) -> Tuple[Tuple[int, int], int]:
        """(node, time) for instruction (i,j,k): node = i*g2 - j*g1 + k*g3."""
        g1, g2, g3 = self.lattice.g1, self.lattice.g2, self.lattice.g3
        node = (
            i * g2[0] - j * g1[0] + k * g3[0],
            i * g2[1] - j * g1[1] + k * g3[1],
        )
        return node, i + j + k

    @property
    def num_steps(self) -> int:
        return 3 * self.q - 2

    def movement_vectors(self) -> Dict[str, Tuple[int, int]]:
        """Per-step translation of each variable stream (time-invariant mu).

        A_ij is used by instructions (i, j, k) for all k at times i+j+k:
        consecutive uses differ by +g3 per unit time -> A flows along g3.
        B_jk flows along g2; C_ki flows along -g1 (accumulates en route)."""
        g1, g2, g3 = self.lattice.g1, self.lattice.g2, self.lattice.g3
        return {"A": g3, "B": g2, "C": (-g1[0], -g1[1])}

    def systolic_properties(self) -> Dict[str, bool]:
        q = self.q
        occupancy: Dict[Tuple[Tuple[int, int], int], int] = {}
        ok_one_mac = True
        for i in range(q):
            for j in range(q):
                for k in range(q):
                    node, t = self.f(i, j, k)
                    keyt = (node, t)
                    occupancy[keyt] = occupancy.get(keyt, 0) + 1
                    if occupancy[keyt] > 1:
                        ok_one_mac = False
        times = [t for (_, t) in occupancy]
        span_ok = (max(times) - min(times) + 1) == self.num_steps
        mv = self.movement_vectors()
        one_hop = all(self.lattice.link_hops(v) == 1 for v in mv.values())
        return {"one_mac_per_node_step": ok_one_mac,
                "time_span_3q_minus_2": span_ok,
                "one_link_per_step": one_hop}

    def simulate(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        """Execute the schedule literally: every instruction (i,j,k) fires at
        f(i,j,k) and accumulates A[i,j]*B[j,k] into C[k,i] (paper layout
        C_ki += A_ij * B_jk); returns C as (AB) in C[k,i] = (A@B)[i,k]."""
        q = self.q
        assert A.shape == (q, q) and B.shape == (q, q)
        C = np.zeros((q, q), dtype=np.result_type(A, B))
        # Group instructions by time step to emulate the systolic wavefront.
        for t in range(0, 3 * q - 2):
            for i in range(q):
                for j in range(q):
                    k = t - i - j
                    if 0 <= k < q:
                        C[k, i] += A[i, j] * B[j, k]
        return C

    def reference(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        return (A @ B).T  # C[k,i] = (A@B)[i,k]
