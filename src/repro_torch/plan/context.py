"""Opt-in mesh context routing layer matmuls through the plan engine.

Counterpart of ``repro.plan.context``.  ``repro_torch.layers.linear`` (and
everything built on it: mlp, attention) checks ``planned_mesh()``: inside a
``planned_matmuls(mesh)`` scope its x @ w products dispatch through
``repro_torch.plan`` -- cost-model-ranked strategy, plan cache, batch
folding -- instead of the purely local multiply.  Outside the scope
nothing changes.

``planned_matmuls(mesh, strategy=...)`` additionally pins every in-scope
product to one strategy instead of letting the cost model rank, and
``tuning=`` (a ``repro_torch.tune`` table or live ``Tuner``) prices the
compute side of in-scope plans with measured kernel seconds and runs
their winning blocks.  The scope lives in a ``ContextVar``, so it is per
thread (and per task).
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional, Tuple

_PLAN_SCOPE: ContextVar[Optional[Tuple[object, Optional[str], Optional[object]]]] = \
    ContextVar("repro_torch_plan_scope", default=None)


def planned_mesh():
    """The mesh layer matmuls should plan against, or None (local path)."""
    scope = _PLAN_SCOPE.get()
    return None if scope is None else scope[0]


def planned_strategy() -> Optional[str]:
    """The strategy override pinned by the enclosing ``planned_matmuls``
    scope, or None (the cost model ranks)."""
    scope = _PLAN_SCOPE.get()
    return None if scope is None else scope[1]


def planned_tuning():
    """The tuning table/tuner the enclosing ``planned_matmuls`` scope
    supplies to ``build_plan``, or None (peak-FLOPs compute model)."""
    scope = _PLAN_SCOPE.get()
    return None if scope is None else scope[2]


def current_scope():
    """The enclosing ``planned_matmuls`` scope as one value (None outside
    any), for ``restore_scope`` to carry into another thread: autograd's
    device thread, where a recompute under ``torch.utils.checkpoint``
    runs, does not see this thread's ``ContextVar``."""
    return _PLAN_SCOPE.get()


@contextlib.contextmanager
def restore_scope(scope):
    """Make ``scope`` (a ``current_scope()`` value) the plan scope within."""
    token = _PLAN_SCOPE.set(scope)
    try:
        yield
    finally:
        _PLAN_SCOPE.reset(token)


@contextlib.contextmanager
def planned_matmuls(mesh, strategy: Optional[str] = None, tuning=None):
    """Route layer matmuls through ``repro_torch.plan`` on ``mesh`` within
    scope; ``strategy`` optionally pins the schedule instead of cost-model
    ranking (validated per shape by ``build_plan`` at dispatch time);
    ``tuning`` (a ``repro_torch.tune`` table or live ``Tuner``) prices the
    compute side of in-scope plans with measured kernel seconds."""
    with restore_scope((mesh, strategy, tuning)):
        yield mesh
