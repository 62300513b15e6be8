"""Inter-device lowering: a ``SchedulePlan`` as per-rank programs on a mesh.

Counterpart of ``repro.plan.lower_shard_map``.  Each strategy is one
lowering *rule* that composes

  pad -> scatter by in_specs -> run the body on every rank -> gather by
  out_specs -> slice back

where the body comes from the dist modules (``torus_program_body`` for
anything with a ``TorusSchedule``, the ring chains of
``repro_torch.dist.ring``, the gather / pod-reduce bodies of
``repro_torch.dist.summa`` / ``pod25d`` / ``fattree``) and the per-rank
block multiply from the plan's tiling via ``lower_local``.  ``spmd`` is
the shard_map analogue that runs one body over a ``Mesh``.

Specs follow ``jax.sharding.PartitionSpec``: one entry per dim, ``None``
(whole), an axis name, or a tuple of names (the dim is cut into the
product of their sizes, blocks numbered row-major over the names, the
first name major).  An output spec that omits a mesh axis is replicated
over it; the gather takes replica 0.  The scatter copies each rank's block
into a tensor of its own on the rank's device, weights included, as
shard_map reshards an unsharded input on every call.

``execute_plan`` adds the batching layer: leading batch dims of the left
operand fold into the rows (the same global matmul with m' = prod(batch)
* m); a batched right operand runs the 2-D program per batch element.
"""
from __future__ import annotations

import collections
import functools
import math
import threading
from typing import Dict, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.dist._util import pad_to
from repro_torch.dist.cannon import torus_program_body, torus_program_body_overlapped
from repro_torch.dist.fattree import fattree_body
from repro_torch.dist.mesh import as_axes
from repro_torch.dist.pod25d import (cannon25d_body, pod25d_slab_body, pod25d_summa_body,
                                     pod25d_summa_overlapped_body)
from repro_torch.dist.ring import ring_ag_matmul, ring_rs_matmul
from repro_torch.dist.summa import summa_body, summa_overlapped_body

from .ir import SchedulePlan
from .lower_local import lower_local


def P(*entries) -> tuple:
    """A partition spec (see the module docstring)."""
    return tuple(entries)


# Lowering observers: callbacks fire with the plan on every lowering
# request (cached or not), so a checker can learn which plan is behind the
# collectives it counts.
_LOWER_OBSERVERS = []

# Products executed per (strategy, overlap), counted by ``execute_plan``.
executions: Dict[Tuple[str, bool], int] = collections.Counter()
_executions_lock = threading.Lock()


def reset_executions() -> None:
    with _executions_lock:
        executions.clear()


def executions_snapshot() -> Dict[str, int]:
    """``executions`` keyed ``"strategy"`` or ``"strategy+ov"``."""
    with _executions_lock:
        return {f"{s}+ov" if ov else s: n for (s, ov), n in sorted(executions.items())}


def on_lower(callback):
    """Register ``callback(plan)`` to fire on each ``lower_dist`` call;
    returns a zero-argument unregister function."""
    _LOWER_OBSERVERS.append(callback)

    def remove():
        try:
            _LOWER_OBSERVERS.remove(callback)
        except ValueError:
            pass

    return remove


def _notify_lower(plan: SchedulePlan) -> None:
    for cb in tuple(_LOWER_OBSERVERS):
        cb(plan)


# -- scatter / gather -------------------------------------------------------------


def _dim_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else as_axes(entry)


def block_slices(shape: Sequence[int], spec: tuple, mesh, rank: int) -> Tuple[slice, ...]:
    """The slices of a global array of ``shape`` that ``rank`` holds under
    ``spec`` (every sharded dim divisible by its axes' size)."""
    out = []
    for d, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        parts = mesh.axis_size(axes)
        if shape[d] % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split into {parts} blocks")
        size = shape[d] // parts
        idx = mesh.axis_index(rank, axes)
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def scatter(x: torch.Tensor, spec: tuple, mesh, ranks=None) -> Dict[int, torch.Tensor]:
    """Each rank's block of ``x`` under ``spec``: a contiguous copy of its
    own on the mesh's device."""
    ranks = mesh.local_ranks() if ranks is None else ranks
    out = {}
    for r in ranks:
        view = x[block_slices(x.shape, spec, mesh, r)]
        blk = torch.empty(view.shape, dtype=x.dtype, device=mesh.device)
        out[r] = blk.copy_(view)
    return out


def gather(outs: Dict[int, torch.Tensor], spec: tuple, mesh) -> torch.Tensor:
    """The global array whose blocks under ``spec`` are ``outs`` (every
    rank's): mesh axes the spec omits are replicas, and replica 0 (the
    ranks at coordinate 0 on those axes) supplies each block."""
    used = {a for entry in spec for a in _dim_axes(entry)}
    first = outs[0]
    shape = [n * mesh.axis_size(_dim_axes(e)) if _dim_axes(e) else n
             for n, e in zip(first.shape, spec)]
    full = torch.empty(shape, dtype=first.dtype, device=first.device)
    for r, blk in outs.items():
        coords = dict(zip(mesh.axis_names, mesh.coords(r)))
        if any(coords[a] for a in mesh.axis_names if a not in used):
            continue
        full[block_slices(shape, spec, mesh, r)] = blk
    return full


def spmd(body, mesh, in_specs: Sequence[tuple], out_spec: tuple):
    """The shard_map analogue: a callable that scatters its operands by
    ``in_specs``, runs ``body`` on every rank of ``mesh`` (its collectives
    through ``repro_torch.dist._collectives``) and gathers the rank outputs
    by ``out_spec``."""

    def run(*operands):
        blocks = [scatter(x, spec, mesh) for x, spec in zip(operands, in_specs)]
        args = {r: tuple(b[r] for b in blocks) for r in mesh.local_ranks()}
        return gather(mesh.collect(mesh.run(body, args)), out_spec, mesh)

    return run


# -- the lowering rules -------------------------------------------------------------


def lower_dist(plan: SchedulePlan):
    """Compile ``plan`` to a callable executing one global 2-D matmul
    (m, k) x (k, n) -> (m, n) as the planned per-rank programs.

    Memoized per plan (``SchedulePlan`` is frozen, and hashable whenever
    its mesh is -- always true for ``Mesh``); plans built on unhashable
    mesh stand-ins lower uncached.  A ``plan.lower`` span under obs
    tracing."""
    _notify_lower(plan)
    with obs.span("plan.lower", strategy=plan.strategy, overlap=plan.overlap):
        try:
            return _lower_dist_cached(plan)
        except TypeError:
            return _lower_dist(plan)


@functools.lru_cache(maxsize=256)
def _lower_dist_cached(plan: SchedulePlan):
    return _lower_dist(plan)


def _lower_dist(plan: SchedulePlan):
    local_fn = lower_local(plan)
    out_dtype = plan.out_dtype
    if plan.strategy == "local" or plan.mesh is None or plan.mesh.size == 1:
        return lambda a, b: local_fn(a, b, out_dtype=out_dtype)
    body, in_specs, out_spec = rule(plan, local_fn)
    return _padded(spmd(body, plan.mesh, in_specs, out_spec), plan)


def rule(plan: SchedulePlan, local_fn=None):
    """The lowering rule of a multi-rank ``plan``: (per-rank body, in_specs,
    out_spec).  ``local_fn`` defaults to the plan's tiling lowering."""
    local_fn = local_fn or lower_local(plan)
    out_dtype = plan.out_dtype

    if plan.torus is not None and plan.strategy != "cannon25d":
        # cannon / any valid 2-D torus solution: execute the reified program
        ax, ay = plan.axes
        body_fn = (torus_program_body_overlapped if plan.overlap
                   else torus_program_body)
        inner = body_fn(plan.torus, ax, ay, local_fn=local_fn)
        return (lambda ab, bb: inner(ab, bb).to(out_dtype),
                (P(ax, ay), P(ax, ay)), P(ax, ay))

    if plan.strategy == "summa":
        ax, ay = plan.axes
        summa_fn = summa_overlapped_body if plan.overlap else summa_body
        return (summa_fn(ax, ay, out_dtype, local_fn=local_fn),
                (P(ax, ay), P(ax, ay)), P(ax, ay))

    if plan.strategy == "fattree":
        tr, ax, ay = plan.axes
        return (fattree_body(tr, ax, ay, plan.grid[0], out_dtype, local_fn=local_fn),
                (P(ax, (tr, ay)), P(ax, (tr, ay))), P(ax, (tr, ay)))

    if plan.strategy == "cannon25d":
        pod, ax, ay = plan.axes
        return (cannon25d_body(pod, ax, ay, plan.torus, out_dtype,
                               local_fn=local_fn, overlap=plan.overlap),
                (P(ax, (pod, ay)), P((pod, ax), ay)), P(ax, ay))

    if plan.strategy == "pod25d":
        pod = plan.axes[0]
        if len(plan.axes) >= 3:
            ax, ay = plan.axes[1], plan.axes[2]
            pod_fn = (pod25d_summa_overlapped_body if plan.overlap
                      else pod25d_summa_body)
            return (pod_fn(pod, ax, ay, out_dtype, local_fn=local_fn),
                    (P(ax, (pod, ay)), P((pod, ax), ay)), P(ax, ay))
        return (pod25d_slab_body(pod, out_dtype, local_fn=local_fn),
                (P(None, pod), P(pod, None)), P(None, None))

    if plan.strategy in ("ring_ag", "ring_rs"):
        axis = plan.axes[0] if len(plan.axes) == 1 else tuple(plan.axes)
        if plan.strategy == "ring_ag":
            # sharded dims: m (rows of a) and n (cols of b)
            return (lambda xl, wl: ring_ag_matmul(xl, wl, axis, out_dtype=out_dtype,
                                                  local_fn=local_fn),
                    (P(axis, None), P(None, axis)), P(None, axis))
        # sharded dims: the contraction k and the output rows m
        return (lambda yl, wl: ring_rs_matmul(yl, wl, axis, out_dtype=out_dtype,
                                              local_fn=local_fn),
                (P(None, axis), P(axis, None)), P(axis, None))

    raise ValueError(f"no per-rank lowering rule for {plan.strategy!r}")


def _padded(f, plan: SchedulePlan):
    """Wrap a per-rank program with the plan's zero-pad / slice-back."""

    def run(a, b):
        m, n = a.shape[0], b.shape[1]
        out = f(pad_to(a, plan.pad_a), pad_to(b, plan.pad_b))
        return out[:m, :n] if tuple(out.shape) != (m, n) else out

    return run


def execute_plan(plan: SchedulePlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run ``plan`` on concrete operands, handling leading batch dims.

    a: (batch..., m, k); b: (k, n) or (batch..., k, n).  A batched left
    operand against a 2-D right operand is folded into the rows; batched
    pairs run the 2-D program per flattened batch element.  Under obs
    tracing the run is a ``plan.execute`` span, whose strategy tag every
    collective of the rank threads inherits.
    """
    if a.shape[-1] != b.shape[-2 if b.ndim > 1 else 0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x {tuple(b.shape)}")
    run = lower_dist(plan)
    with _executions_lock:
        executions[(plan.strategy, plan.overlap)] += 1
    with obs.span("plan.execute", strategy=plan.strategy, overlap=plan.overlap,
                  m=plan.m, n=plan.n, k=plan.k):
        return _execute(run, a, b)


def _execute(run, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.ndim == 2 and b.ndim == 2:
        return run(a, b)
    if a.ndim > 2 and b.ndim == 2:
        batch = tuple(a.shape[:-2])
        m, k = a.shape[-2], a.shape[-1]
        out = run(a.reshape(math.prod(batch) * m, k), b)
        return out.reshape(batch + (m, b.shape[-1]))
    if a.ndim == b.ndim and a.ndim > 2 and a.shape[:-2] == b.shape[:-2]:
        batch = tuple(a.shape[:-2])
        af = a.reshape((-1,) + tuple(a.shape[-2:]))
        bf = b.reshape((-1,) + tuple(b.shape[-2:]))
        out = torch.stack([run(x, y) for x, y in zip(af, bf)])
        return out.reshape(batch + tuple(out.shape[-2:]))
    raise ValueError(
        f"unsupported operand ranks for planned matmul: {tuple(a.shape)} x {tuple(b.shape)}")
