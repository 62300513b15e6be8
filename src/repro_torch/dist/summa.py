"""SUMMA: the broadcast-based stationary-C strategy, for contrast with
Cannon's permute chains.

Counterpart of ``repro.dist.summa``.  SUMMA's per-step row/column panel
broadcasts, summed over the q steps, are exactly a tiled all-gather of A
along the mesh columns and of B along the mesh rows, so the staged
lowering rule (``summa_body``) emits the fused form: two all-gathers plus
one local matmul.  The overlapped rule (``summa_overlapped_body``)
decomposes them into one-hop ppermute chains: the B column panel is
chain-gathered first (nothing to multiply yet -- exposed), then the A
k-slabs walk their ring with each hop started *before* the partial
multiply against the matching B slab and finished after it
(``ppermute_start`` / ``ppermute_done``).  Both bodies move the identical per-rank
words ((qy-1) A-shards + (qx-1) B-shards); the overlapped output differs
from the staged single product only by fp32 summation order.

Unlike Cannon, SUMMA tolerates rectangular meshes.  The ``*_body``
functions are the lowering rules run by ``repro_torch.plan.lower_dist``;
``summa_matmul`` is a facade over the plan engine.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs

from . import _collectives
from .local import local_matmul


def summa_body(axis_x: str, axis_y: str, out_dtype, local_fn=None):
    """Per-rank body: tiled all-gathers of the A-row / B-column panels
    followed by one local multiply (the fused SUMMA step sum)."""
    local_fn = local_fn or local_matmul

    def body(ab, bb):
        arow = _collectives.all_gather(ab, axis_y, axis=1, tiled=True)  # (M/qx, K)
        bcol = _collectives.all_gather(bb, axis_x, axis=0, tiled=True)  # (K, N/qy)
        return local_fn(arow, bcol, out_dtype=out_dtype)

    return body


def gather_chain(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """One-hop ppermute chain equivalent of
    ``all_gather(x, axis_name, axis=0, tiled=True)``: each of the g - 1
    steps writes the resident shard into its origin slot and forwards it
    one hop around the ring."""
    g = _collectives.axis_size(axis_name)
    idx = _collectives.axis_index(axis_name)
    rows = x.shape[0]
    out = torch.zeros((g * rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    perm = [(d, (d + 1) % g) for d in range(g)]
    cur = x
    for s in range(g):
        src = (idx - s) % g  # origin rank of the resident shard
        out[src * rows:(src + 1) * rows] = cur
        if s < g - 1:
            cur = _collectives.ppermute(cur, axis_name, perm)
    return out


def summa_overlapped_body(axis_x: str, axis_y: str, out_dtype,
                          local_fn=None):
    """Per-rank body: pipelined SUMMA with decomposed gathers (the B panel
    chain-gathered over ``axis_x``, then A's k-slabs walking the ``axis_y``
    ring, each hop started before the partial multiply on the resident
    slab and finished after it)."""
    local_fn = local_fn or local_matmul

    def body(ab, bb):
        bcol = gather_chain(bb, axis_x)                    # (K, N/qy)
        qy = _collectives.axis_size(axis_y)
        iy = _collectives.axis_index(axis_y)
        ky = ab.shape[1]                                   # K / qy
        perm = [(d, (d + 1) % qy) for d in range(qy)]
        acc = torch.zeros((ab.shape[0], bb.shape[1]), dtype=torch.float32, device=ab.device)
        cur = ab
        for s in range(qy):
            nxt = None
            if s < qy - 1:
                with obs.span("dist.prefetch", comm="hidden"):
                    nxt = _collectives.ppermute_start(cur, axis_y, perm)
            src = (iy - s) % qy  # k-slab index of the resident A chunk
            bslab = bcol[src * ky:(src + 1) * ky]
            acc = acc + local_fn(cur, bslab, out_dtype=torch.float32)
            cur = _collectives.ppermute_done(nxt) if nxt is not None else None
        return acc.to(out_dtype)

    return body


def summa_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh,
                 axis_x: str = "x", axis_y: str = "y",
                 out_dtype: Optional[torch.dtype] = None, overlap=None) -> torch.Tensor:
    """Global (M, K) x (K, N) matmul, SUMMA-scheduled over (axis_x, axis_y).
    ``overlap=False`` forces the staged body, ``True`` the gather-chain
    body; the default lets the planner pick."""
    from repro_torch.plan import build_plan, execute_plan

    plan = build_plan(
        a.shape[-2], b.shape[-1], a.shape[-1], mesh=mesh, strategy="summa",
        axes=(axis_x, axis_y), batch=tuple(a.shape[:-2]),
        a_dtype=a.dtype, b_dtype=b.dtype, out_dtype=out_dtype,
        overlap=overlap,
    )
    return execute_plan(plan, a, b)
