"""repro_torch.dist -- schedule execution (port of ``repro.dist``).

The equivariant schedules of ``repro_torch.core`` run as per-rank programs
over a ``Mesh`` (``mesh.py``), their data movement through the collective
seam ``_collectives.py`` (rank threads of one process, or a
``torch.distributed`` process group):

  cannon    -- the solver's Cannon solution run verbatim: placement perms
               for the skew, movement-homomorphism perms for the shifts
  summa     -- the broadcast (all-gather) stationary-C contrast strategy
  pod25d    -- replicate--compute--reduce over a pod axis, composable with
               an in-layer strategy (cannon25d)
  fattree   -- the recursive fat-tree schedule over a tree axis of pods
  ring      -- the 1-D torus solutions as one-hop ppermute chains
  api       -- analytic cost model (estimate), strategy selection (choose),
               and dispatch (symmetric_matmul)

Program composition -- padding, specs, batch folding, plan caching --
lives in ``repro_torch.plan``; every rank's block product is
``local.local_matmul``, which runs K1 on the card.
"""
from ._util import pad_to
from .api import Estimate, applicable_strategies, choose, estimate, symmetric_matmul
from .cannon import (cannon_matmul, executed_shift_vectors, lowered_plan, torus_body,
                     torus_schedule_matmul)
from .fattree import fattree_matmul
from .local import local_matmul
from .mesh import Mesh, parse_mesh
from .pod25d import cannon25d_matmul, pod25d_matmul
from .ring import ring_ag_matmul, ring_rs_matmul
from .summa import summa_matmul

__all__ = [
    "Estimate", "Mesh", "applicable_strategies", "cannon25d_matmul", "cannon_matmul",
    "choose", "estimate", "executed_shift_vectors", "fattree_matmul", "local_matmul",
    "lowered_plan", "pad_to", "parse_mesh", "pod25d_matmul", "ring_ag_matmul",
    "ring_rs_matmul", "summa_matmul", "symmetric_matmul", "torus_body",
    "torus_schedule_matmul",
]
