"""Device-independent scheduling algebra copied from ``repro.core``.

Public surface (the reference's, module for module):
  groups         -- cyclic/product/permutation/wreath groups, hex lattice
  homomorphism   -- generator-image homomorphisms + Lemmas 3-5 checks
  schedule       -- TorusSchedule / Torus25DSchedule equivariant maps
  solver         -- enumerate & rank schedules (recovers Cannon et al.)
  cost           -- word/time costs, lower bounds, the reference's constants
  fattree        -- recursive wreath-product schedules (Sec. 4.2)
  hexarray       -- systolic hex-array schedule + simulator (Sec. D.2)
  zorder         -- space-bounded schedules as Morton orders (Sec. 4.3)
"""
from . import cost, fattree, groups, hexarray, homomorphism, schedule, solver, zorder
from .cost import perm_link_words
from .fattree import FatTreeSchedule, tree_exchange_perm
from .schedule import (Torus25DSchedule, TorusSchedule, cannon_schedule,
                       movement_equations_hold, perm_is_bijection, perm_translation,
                       torus_hops)
from .solver import Solution, is_cannon_like, minimal_hop_cost, solve_torus
from .zorder import (enclosing_pow2, morton_decode3, morton_encode3,
                     rowmajor_schedule, zorder_schedule)

__all__ = [
    "cost", "fattree", "groups", "hexarray", "homomorphism", "schedule",
    "solver", "zorder", "TorusSchedule", "Torus25DSchedule", "cannon_schedule",
    "torus_hops", "Solution", "solve_torus", "minimal_hop_cost", "is_cannon_like",
    "perm_is_bijection", "perm_translation", "movement_equations_hold",
    "perm_link_words",
    "FatTreeSchedule", "enclosing_pow2", "morton_decode3", "morton_encode3",
    "rowmajor_schedule", "tree_exchange_perm", "zorder_schedule",
]
