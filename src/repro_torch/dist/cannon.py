"""Torus-schedule lowering rules: equivariant schedules as ppermute programs.

Counterpart of ``repro.dist.cannon``: the algebra->execution bridge.  A
valid ``TorusSchedule`` (a solution of the paper's commutative-diagram
equations) lowers to a per-rank program whose every data movement is a
``ppermute`` whose permutation comes verbatim from the schedule:

  * the initial skew is ``schedule.placement_perm(var)`` -- the schedule's
    l_I layout (for Cannon, the classic A_ij -> P_{i, j-i} skew),
  * each time step shifts A/B/C by ``schedule.movement_perm(var)`` -- the
    movement homomorphism mu translated to (src, dst) rank pairs,
  * the output is collected by ``schedule.collection_perm("C", t-1)``
    (identity for stationary-C schedules like Cannon, and then skipped).

``torus_program_body`` is the lowering *rule*: the per-rank body run by
``repro_torch.plan.lower_dist`` (and by the in-layer phase of the 2.5D rule
in ``repro_torch.dist.pod25d``).  The entry points ``cannon_matmul`` /
``torus_schedule_matmul`` are thin facades over ``repro_torch.plan``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.schedule import TorusSchedule, cannon_schedule

from . import _collectives
from .local import local_matmul


def lowered_plan(schedule: TorusSchedule) -> Dict:
    """The complete ppermute program for ``schedule``: per-step shift
    vectors, one-step movement perms, initial-skew perms, and the final
    C-collection perm.  Everything the executor runs comes from here (and
    ``repro_torch.plan.ir.TorusProgram`` reifies it as static IR)."""
    moves = schedule.movements()
    if moves is None:
        raise ValueError("schedule has no consistent movement homomorphisms")
    return {
        "q": schedule.q,
        "steps": schedule.t,
        "shifts": moves,  # {var: (mu_x, mu_y)} -- the solver's solution
        "skew": {v: schedule.placement_perm(v) for v in ("A", "B")},
        "step_perm": {v: schedule.movement_perm(v) for v in ("A", "B", "C")},
        "collect_C": schedule.collection_perm("C", schedule.t - 1),
    }


def executed_shift_vectors(q: int) -> Dict[str, Tuple[int, int]]:
    """Per-step (dx, dy) each variable set moves in ``cannon_matmul`` -- by
    construction the movement homomorphisms of the solver's Cannon
    solution."""
    return lowered_plan(cannon_schedule(q))["shifts"]


def _is_identity(perm) -> bool:
    return perm is None or all(src == dst for src, dst in perm)


def _permute(x, axes, perm):
    if _is_identity(perm):
        return x
    return _collectives.ppermute(x, axes, list(perm))


def _permute_start(x, axes, perm):
    """``_permute`` deferred: a handle for ``_permute_done`` (``x`` itself
    for an identity, which moves nothing)."""
    if _is_identity(perm):
        return x
    return _collectives.ppermute_start(x, axes, list(perm))


def _permute_done(started):
    return started if isinstance(started, torch.Tensor) else _collectives.ppermute_done(started)


def torus_program_body(prog, axis_x: str, axis_y: str, local_fn=None):
    """Per-rank body executing a reified torus program on local
    (M/q, K/q) x (K/q, N/q) blocks; returns the fp32 accumulator in
    canonical C layout.  ``prog`` carries the program fields
    (``repro_torch.plan.ir.TorusProgram``): steps, skew_a/b, step_a/b/c,
    collect_c.  The local block multiply is ``local_fn`` (default
    ``local_matmul``; the plan compiler passes its tiling lowering)."""
    axes = (axis_x, axis_y)
    local_fn = local_fn or local_matmul

    def body(ab, bb):
        ab = _permute(ab, axes, prog.skew_a)
        bb = _permute(bb, axes, prog.skew_b)
        acc = torch.zeros((ab.shape[0], bb.shape[1]), dtype=torch.float32, device=ab.device)
        for step in range(prog.steps):
            acc = acc + local_fn(ab, bb, out_dtype=torch.float32)
            if step < prog.steps - 1:
                ab = _permute(ab, axes, prog.step_a)
                bb = _permute(bb, axes, prog.step_b)
                acc = _permute(acc, axes, prog.step_c)
        return _permute(acc, axes, prog.collect_c)

    return body


def torus_program_body_overlapped(prog, axis_x: str, axis_y: str,
                                  local_fn=None):
    """Double-buffered variant of ``torus_program_body``: step k+1's A/B
    ppermutes are started (``ppermute_start``) BEFORE step k's local
    multiply and finished (``ppermute_done``) after it, before the blocks'
    first use, as XLA's latency-hiding scheduler places the reference's
    ``collective-permute-start`` / ``-done``.  On the card each rank's copy
    runs on its copy stream under the multiply on its compute stream; in a
    process group the sends and receives are in flight under it.  C's
    per-step permute consumes the fresh partial sum and stays after it.

    The permutes and multiplies are the identical operations of the staged
    body in a reordered data-flow: every ``local_fn`` call sees the same
    operands and the accumulator chain is unchanged, so outputs are
    bitwise-identical and the collective multiset is the same."""
    axes = (axis_x, axis_y)
    local_fn = local_fn or local_matmul

    def body(ab, bb):
        ab = _permute(ab, axes, prog.skew_a)
        bb = _permute(bb, axes, prog.skew_b)
        acc = torch.zeros((ab.shape[0], bb.shape[1]), dtype=torch.float32, device=ab.device)
        for step in range(prog.steps):
            nxt_a = nxt_b = None
            if step < prog.steps - 1:
                with obs.span("dist.prefetch", comm="hidden"):
                    nxt_a = _permute_start(ab, axes, prog.step_a)
                    nxt_b = _permute_start(bb, axes, prog.step_b)
            acc = acc + local_fn(ab, bb, out_dtype=torch.float32)
            if step < prog.steps - 1:
                acc = _permute(acc, axes, prog.step_c)
                ab, bb = _permute_done(nxt_a), _permute_done(nxt_b)
        return _permute(acc, axes, prog.collect_c)

    return body


def torus_body(schedule: TorusSchedule, axis_x: str, axis_y: str,
               local_fn=None):
    """``torus_program_body`` over the program reified from ``schedule``
    (the same ``TorusProgram`` the plan IR carries)."""
    from repro_torch.plan.ir import TorusProgram

    return torus_program_body(TorusProgram.from_schedule(schedule),
                              axis_x, axis_y, local_fn=local_fn)


def torus_schedule_matmul(a: torch.Tensor, b: torch.Tensor,
                          schedule: TorusSchedule, *, mesh,
                          axis_x: str = "x", axis_y: str = "y",
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Global (M, K) x (K, N) matmul executing ``schedule`` on the q x q
    torus spanned by mesh axes (axis_x, axis_y).  Facade over the plan
    engine: builds a torus plan carrying the schedule and executes its
    lowering (operands zero-padded to block multiples, result sliced
    back)."""
    from repro_torch.plan import build_plan, execute_plan

    plan = build_plan(
        a.shape[-2], b.shape[-1], a.shape[-1], mesh=mesh, schedule=schedule,
        axes=(axis_x, axis_y), batch=tuple(a.shape[:-2]),
        a_dtype=a.dtype, b_dtype=b.dtype, out_dtype=out_dtype,
    )
    return execute_plan(plan, a, b)


def cannon_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh,
                  axis_x: str = "x", axis_y: str = "y",
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Cannon's algorithm as the executed solver solution: skewed initial
    layout + one-hop A/B shifts, all ppermutes from ``cannon_schedule(q)``."""
    q = mesh.shape[axis_x]
    return torus_schedule_matmul(
        a, b, cannon_schedule(q), mesh=mesh,
        axis_x=axis_x, axis_y=axis_y, out_dtype=out_dtype)
