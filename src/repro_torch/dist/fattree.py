"""Hierarchical fat-tree lowering: the paper's Sec.-4.2 recursive schedule
on a pod-of-pods machine.

Counterpart of ``repro.dist.fattree``.  The mesh carries one inter-pod
**tree** axis (s pods, s a power of two) and an intra-pod (qx, qy) torus
pair.  C and B column panels are stationary per pod, while A's contraction
slabs walk the tree axis in the reflected-Gray XOR order

    slab on pod p at super-step t  =  p ^ t

so the exchange between steps is the involution ``d -> d ^ (t ^ (t+1))``
(``repro_torch.core.fattree.tree_exchange_perm``): the root is crossed
exactly once.  Within a pod B's column panel is gathered over the rows
once (hoisted), A's resident slab shard is gathered over the columns per
step, and the matching B k-slab is sliced out by the slab index.
``fattree_body`` is the lowering rule run by ``repro_torch.plan.lower_dist``;
``fattree_matmul`` is a facade over the plan engine.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fattree import tree_exchange_perm

from . import _collectives
from .local import local_matmul


def fattree_body(tree_axis: str, axis_x: str, axis_y: str, s: int,
                 out_dtype, local_fn=None):
    """Per-rank body for the recursive fat-tree schedule.

    Per-rank operands (specs ``P(x, (tree, y))`` for both A and B):

      ab -- (M/qx, K/(s*qy)): pod p's contraction-slab shard of A
      bb -- (K/qx,  N/(s*qy)): the stationary column panel shard of B

    The body runs s super-steps; at step t pod p multiplies A slab
    ``p ^ t`` against the matching k-rows of its gathered B panel, then
    exchanges its resident A shard along the tree axis with the XOR-mask
    involution that advances every pod's slab to ``p ^ (t + 1)``.
    """
    local_fn = local_fn or local_matmul

    def body(ab, bb):
        bfull = _collectives.all_gather(bb, axis_x, axis=0, tiled=True)
        ks = bfull.shape[0] // s                  # k rows per slab
        p = _collectives.axis_index(tree_axis)
        acc = torch.zeros((ab.shape[0], bb.shape[1]), dtype=torch.float32, device=ab.device)
        cur = ab
        for t in range(s):
            arow = _collectives.all_gather(cur, axis_y, axis=1, tiled=True)
            j = p ^ t                              # resident slab index
            bslab = bfull[j * ks:(j + 1) * ks]
            acc = acc + local_fn(arow, bslab, out_dtype=torch.float32)
            if t < s - 1:
                cur = _collectives.ppermute(cur, tree_axis, tree_exchange_perm(s, t))
        return acc.to(out_dtype)

    return body


def fattree_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh,
                   tree_axis: str = "tree",
                   axis_x: str = "x", axis_y: str = "y",
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Global (M, K) x (K, N) matmul on a pod-of-pods mesh: the recursive
    fat-tree schedule over ``tree_axis`` with a broadcast (qx, qy) torus
    program inside each pod."""
    from repro_torch.plan import build_plan, execute_plan

    plan = build_plan(
        a.shape[-2], b.shape[-1], a.shape[-1], mesh=mesh, strategy="fattree",
        axes=(tree_axis, axis_x, axis_y), batch=tuple(a.shape[:-2]),
        a_dtype=a.dtype, b_dtype=b.dtype, out_dtype=out_dtype,
    )
    return execute_plan(plan, a, b)
