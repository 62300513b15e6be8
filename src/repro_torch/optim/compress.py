"""int8 gradient compression with error feedback for the data-parallel
all-reduce (counterpart of ``repro.optim.compress``).

Quantization rounds half to even and clips to +-127 against one fp32
scale per tensor (its largest magnitude / 127, floored at 1e-12 / 127);
error feedback adds the residual back before the next quantization, which
keeps the quantization bias out of the trajectory.

``compressed_psum`` runs inside a per-rank program (``Mesh.run``, or a
plan body) over the port's collective seam (``dist._collectives.psum``),
with the reference's arithmetic: an int32 psum of the codes and the mean
of the scales.  The codes are summed as int32, as in the reference, so the
seam moves 4 bytes an element, as many as an fp32 psum; an int8 wire
format would need a gather of the codes and a local sum.  Neither
package's trainer calls these.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.dist import _collectives
from repro_torch.tree import tree_leaves, tree_unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, axis, residual: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce mean of ``x`` over ``axis`` in int8 codes, with error
    feedback: (the reduced fp32 value, the new residual)."""
    xf = x.float() + residual
    q, scale = quantize_int8(xf)
    deq = dequantize_int8(q, scale)
    new_residual = xf - deq
    # int8 values sum without overflow in int32 across <= 2^23 shards
    summed = _collectives.psum(q.to(torch.int32), axis)
    scale_sum = _collectives.psum(scale, axis)
    n = _collectives.psum(torch.ones((), dtype=torch.float32, device=x.device), axis)
    # each shard quantized with its own scale: the mean scale stands for
    # them all (exact when the scales agree across replicas)
    mean = summed.float() * (scale_sum / n) / n
    return mean, new_residual


def compress_tree_psum(grads: Any, axis, residuals: Any) -> Tuple[Any, Any]:
    outs, new_res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        o, nr = compressed_psum(g, axis, r)
        outs.append(o.to(g.dtype))
        new_res.append(nr)
    return tree_unflatten(grads, outs), tree_unflatten(grads, new_res)
