"""2.5D lowering rules: replicate--compute--reduce over a pod axis (Sec. D.1).

Counterpart of ``repro.dist.pod25d``.  ``Torus25DSchedule`` splits the
contraction index j = j_c * (q/c) + j_t: the c-part selects a pod layer
(each layer owns a contraction slab), the t-part runs an in-layer 2-D
schedule, and C is reduced over the pod axis at the end:

  pod25d    -- slab matmul per layer (SUMMA in-layer when the mesh also
               has 2-D axes), then psum over the pod axis
  cannon25d -- in-layer Cannon on the slab (the executed
               ``cannon_schedule(q)`` ppermute program of
               ``repro_torch.dist.cannon``), then psum over the pod axis

The operands are scattered over (pod x in-layer) axes jointly by the
lowering's in_specs, so each layer starts with exactly its slab.  The
``*_body`` functions are the lowering rules run by
``repro_torch.plan.lower_dist``; the ``*_matmul`` entry points are facades
over the plan engine.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _collectives
from .cannon import torus_program_body, torus_program_body_overlapped
from .local import local_matmul
from .summa import summa_overlapped_body


def _inlayer_axes(mesh, pod_axis: str, axis_x: Optional[str],
                  axis_y: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    if axis_x is not None and axis_y is not None:
        return axis_x, axis_y
    rest = [nm for nm in mesh.axis_names if nm != pod_axis]
    if len(rest) >= 2:
        return rest[0], rest[1]
    return None, None


def pod25d_slab_body(pod_axis: str, out_dtype, local_fn=None):
    """Lowering rule, no in-layer axes: each layer multiplies its full
    contraction slab locally, then C reduces over the pod axis."""
    local_fn = local_fn or local_matmul

    def body(ab, bb):
        part = local_fn(ab, bb, out_dtype=torch.float32)
        return _collectives.psum(part, pod_axis).to(out_dtype)

    return body


def pod25d_summa_body(pod_axis: str, axis_x: str, axis_y: str, out_dtype,
                      local_fn=None):
    """Lowering rule, SUMMA in-layer: within layer z the A-columns / B-rows
    cover contraction slab z; gather panels, multiply, reduce over pod."""
    local_fn = local_fn or local_matmul

    def body(ab, bb):
        arow = _collectives.all_gather(ab, axis_y, axis=1, tiled=True)  # (M/qx, K/c)
        bcol = _collectives.all_gather(bb, axis_x, axis=0, tiled=True)  # (K/c, N/qy)
        part = local_fn(arow, bcol, out_dtype=torch.float32)
        return _collectives.psum(part, pod_axis).to(out_dtype)

    return body


def pod25d_summa_overlapped_body(pod_axis: str, axis_x: str, axis_y: str,
                                 out_dtype, local_fn=None):
    """Overlapped in-layer variant of ``pod25d_summa_body``: the layer's
    gathers run as pipelined one-hop chains; the pod psum consumes the
    finished partial sum, so it stays monolithic."""
    inner = summa_overlapped_body(axis_x, axis_y, torch.float32, local_fn=local_fn)

    def body(ab, bb):
        return _collectives.psum(inner(ab, bb), pod_axis).to(out_dtype)

    return body


def cannon25d_body(pod_axis: str, axis_x: str, axis_y: str, prog,
                   out_dtype, local_fn=None, overlap: bool = False):
    """Lowering rule, Cannon in-layer: each pod layer executes the reified
    torus program ``prog`` on its contraction slab, and C partial sums
    reduce over the pod axis.  ``overlap`` selects the double-buffered
    in-layer body."""
    body_fn = torus_program_body_overlapped if overlap else torus_program_body
    inner = body_fn(prog, axis_x, axis_y, local_fn=local_fn)

    def body(ab, bb):
        return _collectives.psum(inner(ab, bb), pod_axis).to(out_dtype)

    return body


def pod25d_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh,
                  pod_axis: str = "pod",
                  axis_x: Optional[str] = None, axis_y: Optional[str] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Global matmul with the contraction split over ``pod_axis``; SUMMA
    in-layer when the mesh carries two more axes, else a local slab
    multiply per layer."""
    from repro_torch.plan import build_plan, execute_plan

    ax, ay = _inlayer_axes(mesh, pod_axis, axis_x, axis_y)
    axes = (pod_axis,) if ax is None else (pod_axis, ax, ay)
    plan = build_plan(
        a.shape[-2], b.shape[-1], a.shape[-1], mesh=mesh, strategy="pod25d",
        axes=axes, batch=tuple(a.shape[:-2]),
        a_dtype=a.dtype, b_dtype=b.dtype, out_dtype=out_dtype,
    )
    return execute_plan(plan, a, b)


def cannon25d_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh,
                     pod_axis: str = "pod",
                     axis_x: str = "x", axis_y: str = "y",
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """2.5D with in-layer Cannon over (pod_axis, axis_x, axis_y)."""
    from repro_torch.plan import build_plan, execute_plan

    plan = build_plan(
        a.shape[-2], b.shape[-1], a.shape[-1], mesh=mesh, strategy="cannon25d",
        axes=(pod_axis, axis_x, axis_y), batch=tuple(a.shape[:-2]),
        a_dtype=a.dtype, b_dtype=b.dtype, out_dtype=out_dtype,
    )
    return execute_plan(plan, a, b)
