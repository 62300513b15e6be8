"""Counting interceptor for the port's executed per-rank programs.

Port of ``repro.verify.interceptor``.  ``intercept()`` patches the
collectives of ``repro_torch.dist._collectives`` (the seam every lowering
rule's ppermute / all_gather / psum goes through, called through the
module by the strategy bodies; a deferred ppermute through its
``ppermute_start``) and records one ``CollectiveRecord`` per call, a
deferred ppermute once, as one ppermute.  The reference records once per collective while shard_map traces
its body; the port runs one program per rank, so every rank calls the
seam at run time and the capture keeps each rank's sequence apart:

  * on a single-controller ``Mesh`` the ranks are threads of this
    process, and all of them are captured (under a lock);
  * on a process-group ``Mesh`` each process captures its own rank.

A program's records are one rank's sequence (every rank runs the same
program); ``measure_plan`` fails the ``interceptor`` leg when any rank's
key sequence differs from it.  Beside each record the capture keeps the
element size of the tensor the call carried, which the records' keys
leave out (words are dtype-agnostic) and byte figures need.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.dist import _collectives as seam
from repro_torch.plan import execute_plan, on_lower

from .trace import CollectiveRecord, Trace, canonical_perm


@dataclasses.dataclass
class Capture:
    """Record sink handed out by ``intercept``: per rank, the records of
    its collective calls in call order and the element size each carried."""

    by_rank: Dict[int, List[CollectiveRecord]] = dataclasses.field(default_factory=dict)
    itemsizes_by_rank: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    lowered_plans: List = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False,
                                              compare=False)

    def add(self, rank: int, rec: CollectiveRecord, itemsize: int) -> None:
        with self._lock:
            self.by_rank.setdefault(rank, []).append(rec)
            self.itemsizes_by_rank.setdefault(rank, []).append(itemsize)

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(sorted(self.by_rank))

    @property
    def records(self) -> List[CollectiveRecord]:
        """The program's records: the lowest captured rank's sequence."""
        return list(self.by_rank[self.ranks[0]]) if self.by_rank else []

    @property
    def itemsizes(self) -> List[int]:
        """Element sizes beside ``records``, call for call."""
        return list(self.itemsizes_by_rank[self.ranks[0]]) if self.by_rank else []

    def divergence(self) -> Optional[str]:
        """None when every rank made the lowest rank's calls in its order,
        else where the first rank to differ parts from it."""
        if not self.by_rank:
            return None
        first = self.ranks[0]
        want = [r.key for r in self.by_rank[first]]
        for rank in self.ranks[1:]:
            got = [r.key for r in self.by_rank[rank]]
            if got == want:
                continue
            i = next((i for i, (x, y) in enumerate(zip(want, got)) if x != y),
                     min(len(want), len(got)))
            return (f"rank {rank} made {len(got)} collective calls, rank {first} "
                    f"{len(want)}; first difference at call {i}: rank {first} "
                    f"{want[i] if i < len(want) else None!r}, rank {rank} "
                    f"{got[i] if i < len(got) else None!r}")
        return None


def _record(cap: Capture, kind: str, x: torch.Tensor, axis_name, perm=None) -> None:
    cap.add(seam.rank(),
            CollectiveRecord(kind, seam.axis_size(axis_name), x.numel(),
                             canonical_perm(perm) if kind == "ppermute" else None),
            x.element_size())


@contextlib.contextmanager
def intercept():
    """Patch the collective seam; yields a ``Capture`` that fills with one
    record per collective call made while the context is active, and with
    every plan ``lower_dist`` is asked for (``on_lower``)."""
    cap = Capture()
    orig_ppermute, orig_all_gather, orig_psum = seam.ppermute, seam.all_gather, seam.psum
    orig_start = seam.ppermute_start

    def ppermute(x, axis_name, perm):
        _record(cap, "ppermute", x, axis_name, perm)
        return orig_ppermute(x, axis_name, perm)

    def ppermute_start(x, axis_name, perm):
        _record(cap, "ppermute", x, axis_name, perm)
        return orig_start(x, axis_name, perm)

    def all_gather(x, axis_name, *, axis, tiled):
        _record(cap, "all_gather", x, axis_name)
        return orig_all_gather(x, axis_name, axis=axis, tiled=tiled)

    def psum(x, axis_name):
        _record(cap, "psum", x, axis_name)
        return orig_psum(x, axis_name)

    seam.ppermute, seam.all_gather, seam.psum = ppermute, all_gather, psum
    seam.ppermute_start = ppermute_start
    remove = on_lower(cap.lowered_plans.append)
    try:
        yield cap
    finally:
        remove()
        seam.ppermute, seam.all_gather, seam.psum = orig_ppermute, orig_all_gather, orig_psum
        seam.ppermute_start = orig_start


def _divergence_error(cap: Capture):
    """The [interceptor] ``ConformanceError`` for ranks that ran different
    programs, or None."""
    from .conformance import ConformanceError

    why = cap.divergence()
    return None if why is None else ConformanceError(
        f"[interceptor] the ranks ran different programs: {why}")


def measure_plan(plan, dtype=None) -> Capture:
    """Execute ``plan`` once through ``execute_plan`` on zero operands of the
    folded 2-D problem, on its mesh's device, and return the captured
    records.

    The lowering is the cached one production runs: collectives are
    counted when the ranks call them, so a lowering built earlier still
    reports every call.  Operands default to the plan's ``out_dtype`` so
    dtype-conditioned paths are the ones measured.  Raises
    ``ConformanceError`` ([interceptor]) when the ranks' sequences differ,
    also when that difference made the run itself fail (then chained
    from the run's error)."""
    mesh = plan.mesh
    if not hasattr(mesh, "run"):
        raise ValueError("measure_plan executes the plan: build it on a repro_torch Mesh")
    dtype = dtype if dtype is not None else plan.out_dtype
    flat_m = plan.m * math.prod(plan.batch) if plan.batch else plan.m
    a = torch.zeros((flat_m, plan.k), dtype=dtype, device=mesh.device)
    b = torch.zeros((plan.k, plan.n), dtype=dtype, device=mesh.device)
    with intercept() as cap:
        try:
            execute_plan(plan, a, b)
        except Exception as err:
            diverged = _divergence_error(cap)
            if diverged is not None:
                raise diverged from err
            raise
    diverged = _divergence_error(cap)
    if diverged is not None:
        raise diverged
    return cap


def phase_bytes(trace: Trace, cap: Capture) -> Dict[Tuple[str, str], float]:
    """Mesh-wide bytes per (kind, phase): each trace record's words in the
    trace's counting conventions (psum: 2 (g - 1) shards per group) times
    the element size of the executed call it pairs with.  Trace records
    and executed calls pair by key, in order within a key, so the capture
    must hold exactly the trace's multiset (``compare_records``)."""
    sizes: Dict[Tuple, collections.deque] = collections.defaultdict(collections.deque)
    for rec, size in zip(cap.records, cap.itemsizes):
        sizes[rec.key].append(size)
    out: Dict[Tuple[str, str], float] = collections.defaultdict(float)
    for rec in trace.records:
        out[rec.kind, rec.phase] += rec.words_total(trace.mesh_size) * sizes[rec.key].popleft()
    return dict(out)
