"""Ring collective matmuls: 1-D torus solutions of the paper's equations.

Counterpart of ``repro.dist.ring``.  On a 1-D torus the equivariance
equations admit exactly the one-hop shift solutions; executed, they are
the classic ring algorithms.  Both functions run inside a per-rank program
over a single named axis (or a tuple of names flattened into one ring) and
decompose the all-gather / reduce-scatter into a chain of one-hop
``ppermute`` steps, each issued before the matmul of the chunk currently
resident.

Layout contracts (local shards, ``axis`` the ring axis of size t):

  ring_ag_matmul : x (..., S/t, D) row-sharded, w (D, F/t) col-sharded
                   -> (..., S, F/t)   ("all-gather then matmul", fused)
  ring_rs_matmul : y (..., S, F/t) col-sharded, w (F/t, D) row-sharded
                   -> (..., S/t, D)   ("matmul then reduce-scatter", fused)

Both support 2-D and batched 3-D left operands.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs

from . import _collectives
from .local import local_matmul


def _ring_perm(n: int):
    """One-hop +1 shift on the ring: the mu = 1 movement homomorphism."""
    return [(d, (d + 1) % n) for d in range(n)]


def ring_ag_matmul(x: torch.Tensor, w: torch.Tensor, axis, *,
                   out_dtype: Optional[torch.dtype] = None, local_fn=None) -> torch.Tensor:
    """Fused all-gather(x) @ w_local over ring axis ``axis``: each of the t
    steps multiplies the resident x-chunk against the local weight shard
    and writes the product into its global row slot, while the chunk
    ring-shifts one hop for the next step."""
    local_fn = local_fn or local_matmul
    n = _collectives.axis_size(axis)
    idx = _collectives.axis_index(axis)
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, w.dtype)
    chunk = x.shape[-2]
    out = torch.zeros(tuple(x.shape[:-2]) + (n * chunk, w.shape[-1]),
                      dtype=out_dtype, device=x.device)
    perm = _ring_perm(n)
    cur = x
    for s in range(n):
        # issue the permute first so it can overlap the matmul below
        nxt = None
        if s < n - 1:
            with obs.span("dist.prefetch", comm="hidden"):
                nxt = _collectives.ppermute(cur, axis, perm)
        prod = local_fn(cur, w, out_dtype=out_dtype)
        src = (idx - s) % n  # origin rank of the resident chunk
        out[..., src * chunk:(src + 1) * chunk, :] = prod
        cur = nxt
    return out


def ring_rs_matmul(y: torch.Tensor, w: torch.Tensor, axis, *,
                   out_dtype: Optional[torch.dtype] = None, local_fn=None) -> torch.Tensor:
    """Fused (y @ w_local) reduce-scatter over ring axis ``axis``: the local
    partial product is full-height (fp32); the reduction walks the ring
    accumulating the row-chunk destined for each rank, one hop per step."""
    local_fn = local_fn or local_matmul
    n = _collectives.axis_size(axis)
    idx = _collectives.axis_index(axis)
    if out_dtype is None:
        out_dtype = torch.promote_types(y.dtype, w.dtype)
    partial = local_fn(y, w, out_dtype=torch.float32)
    rows = partial.shape[-2]
    if rows % n:
        raise ValueError(f"rows {rows} not divisible by ring size {n}")
    chunk = rows // n
    perm = _ring_perm(n)
    acc: Optional[torch.Tensor] = None
    for s in range(n):
        c = (idx + n - 1 - s) % n  # chunk index this rank contributes now
        mine = partial[..., c * chunk:(c + 1) * chunk, :]
        acc = mine if acc is None else acc + mine
        if s < n - 1:
            acc = _collectives.ppermute(acc, axis, perm)
    return acc.to(out_dtype)
