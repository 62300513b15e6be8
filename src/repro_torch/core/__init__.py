"""Device-independent scheduling algebra copied from ``repro.core``:
Z-order tilings, the equivariant torus and 2.5D schedules, the fat-tree
schedule and the analytic cost model."""
from .fattree import FatTreeSchedule, tree_exchange_perm
from .schedule import Torus25DSchedule, TorusSchedule, cannon_schedule, torus_hops
from .zorder import (enclosing_pow2, morton_decode3, morton_encode3,
                     rowmajor_schedule, zorder_schedule)

__all__ = ["FatTreeSchedule", "Torus25DSchedule", "TorusSchedule", "cannon_schedule",
           "enclosing_pow2", "morton_decode3", "morton_encode3", "rowmajor_schedule",
           "torus_hops", "tree_exchange_perm", "zorder_schedule"]
