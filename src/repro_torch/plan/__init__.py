"""repro_torch.plan -- the unified schedule-plan IR (port of ``repro.plan``).

The paper's thesis is that one algebraic object -- an equivariant map fixed
by a homomorphism of the iteration-space symmetry group -- describes a
matmul schedule at every machine level.  ``SchedulePlan`` reifies that
object between the solver (``repro_torch.core``) and the two machine
levels it lowers to:

    solver (core)  -->  SchedulePlan  -->  lower_dist   (per-rank programs on a Mesh)
                                    \\->  lower_local  (the rank's block multiply: K1)

``build_plan`` is the planner (topology filters, the cost model ranks);
``execute_plan`` folds leading batch dims and runs the per-rank lowering;
the plan cache memoizes plans per (shapes, dtypes, mesh fingerprint,
strategy override).  ``repro_torch.dist.api.symmetric_matmul`` is a thin
facade over this package, and ``planned_matmuls`` routes the layer
library's x @ w products through it.
"""
from repro_torch.dist.api import Estimate, estimate  # noqa: F401

from .cache import PlanCache, cache_clear, cache_info, cache_stats, plan_cache
from .context import planned_matmuls, planned_mesh, planned_strategy, planned_tuning
from .ir import (SchedulePlan, TilingPlan, TorusProgram, build_plan, mesh_candidates,
                 mesh_fingerprint, rank_mesh_strategies, strategy_seconds)
from .lower_dist import execute_plan, lower_dist, on_lower, spmd
from .lower_local import lower_local, lower_tiling

__all__ = [
    "SchedulePlan", "TilingPlan", "TorusProgram", "build_plan",
    "mesh_candidates", "mesh_fingerprint", "rank_mesh_strategies",
    "strategy_seconds", "execute_plan", "lower_dist", "on_lower", "spmd",
    "lower_local", "lower_tiling",
    "PlanCache", "plan_cache", "cache_stats", "cache_info", "cache_clear",
    "planned_matmuls", "planned_mesh", "planned_strategy", "planned_tuning",
    "Estimate", "estimate",
]
