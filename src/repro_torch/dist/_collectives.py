"""Interceptable collective seam for the per-rank programs.

Counterpart of ``repro.dist._collectives``.  Every word a lowered schedule
moves goes through ``ppermute``, ``all_gather`` or ``psum`` here (the
reference's three names, which ``repro_torch.verify.interceptor`` patches);
``axis_index`` and ``axis_size`` answer a rank's place on the mesh, as
``lax.axis_index`` and ``lax.psum(1, axis)`` do inside the reference's
shard_map bodies, and ``rank`` the calling rank's number.  Each call goes
to the communicator of the rank the calling thread runs (``current``), one
of two:

* ``ThreadCommunicator`` -- the single controller: the mesh's ranks are
  threads of one process, and a collective is a barrier exchange over a
  shared ``Rendezvous``: each rank posts its tensor, all wait, each takes
  what it receives (a copy onto its device), all wait again.  All ranks on
  one card launch on the caller's current stream, so their kernels run in
  the order the threads issue them and a copy never runs ahead of the
  kernel that wrote its source.
* ``ProcessGroupCommunicator`` -- one rank per process over
  ``torch.distributed``: ``ppermute`` is ``batch_isend_irecv``,
  ``all_gather`` an all-gather into one tensor on the axis' subgroup,
  ``psum`` an ``all_reduce`` on it.

Semantics follow ``jax.lax``: ``perm`` pairs are (source, destination)
positions in the group over the named axes (``Mesh.axis_index``); a rank
no pair sends to receives zeros; ``all_gather`` stacks the group's tensors
in group order, or concatenates them along ``axis`` when ``tiled``;
``psum`` gives every member the sum (in group order).

``stats`` counts, per kind, the calls and the bytes each rank received
from another rank (a rank's own block moves nothing): the measured side of
the plan's ``cost.comm_bytes``.  Under the cost counter
(``repro_torch.roofline.hlo_stats``) each call is also counted, in the
reference's kinds and output-shape bytes, and the communicator's own
copies are not counted as ops.

When ``repro_torch.obs`` tracing is enabled, each call also records one
``CollectiveEvent`` (kind, group size, shard words, canonical perm, the
ambient strategy tag) and bumps the ``dist.collective.count`` /
``dist.collective.words`` counters.  The reference records once per call
while tracing the body; here every rank calls at run time, so only the
lowest local rank records (a program's records, as the interceptor takes
them), and ``obs.collective_multiset()`` equals the interceptor's
multiset.  The interceptor patches the three names and calls these, so
both see the same calls when active together.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from repro_torch import obs
from repro_torch.roofline import hlo_stats

from .mesh import as_axes

KINDS = ("ppermute", "all_gather", "psum")

_local = threading.local()
_stats_lock = threading.Lock()
stats: Dict[str, Dict[str, int]] = {k: {"calls": 0, "bytes": 0} for k in KINDS}


def reset_stats() -> None:
    with _stats_lock:
        for k in KINDS:
            stats[k] = {"calls": 0, "bytes": 0}


def _count(kind: str, nbytes: int) -> None:
    with _stats_lock:
        stats[kind]["calls"] += 1
        stats[kind]["bytes"] += nbytes


class RankAborted(RuntimeError):
    """Raised in a rank whose collective was cut short because another rank
    failed, left the program early or timed out."""


@contextlib.contextmanager
def current(comm):
    """Make ``comm`` the calling thread's communicator within the scope."""
    prev = getattr(_local, "comm", None)
    _local.comm = comm
    try:
        yield comm
    finally:
        _local.comm = prev


def _comm():
    comm = getattr(_local, "comm", None)
    if comm is None:
        raise RuntimeError("a collective was called outside a per-rank program "
                           "(Mesh.run sets the rank's communicator)")
    return comm


# -- the seam -----------------------------------------------------------------


def _observe(comm, kind: str, x: torch.Tensor, axes, perm=None) -> None:
    """Record one collective in the obs layer (enabled mode, lowest local
    rank only)."""
    if comm.rank != comm.mesh.local_ranks()[0]:
        return
    words = x.numel()
    obs.record_collective(kind, comm.mesh.axis_size(axes), words, perm)
    obs.counter("dist.collective.count").inc(kind=kind)
    obs.counter("dist.collective.words").inc(words, kind=kind)


def ppermute(x: torch.Tensor, axis_name, perm) -> torch.Tensor:
    comm, axes = _comm(), as_axes(axis_name)
    if obs.enabled():
        _observe(comm, "ppermute", x, axes, perm)
    with hlo_stats.collective("ppermute", x, x.numel()):
        return comm.ppermute(x, axes, perm)


def all_gather(x: torch.Tensor, axis_name, *, axis: int, tiled: bool) -> torch.Tensor:
    comm, axes = _comm(), as_axes(axis_name)
    if obs.enabled():
        _observe(comm, "all_gather", x, axes)
    with hlo_stats.collective("all_gather", x, x.numel() * comm.mesh.axis_size(axes)):
        return comm.all_gather(x, axes, axis=axis, tiled=tiled)


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    comm, axes = _comm(), as_axes(axis_name)
    if obs.enabled():
        _observe(comm, "psum", x, axes)
    with hlo_stats.collective("psum", x, x.numel()):
        return comm.psum(x, axes)


def axis_index(axis_name) -> int:
    comm = _comm()
    return comm.mesh.axis_index(comm.rank, axis_name)


def axis_size(axis_name) -> int:
    return _comm().mesh.axis_size(axis_name)


def rank() -> int:
    """The calling rank's number on its mesh."""
    return _comm().rank


def _source(perm, me: int) -> Optional[int]:
    for src, dst in perm:
        if dst == me:
            return int(src)
    return None


def _combine(parts, axis: int, tiled: bool) -> torch.Tensor:
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


# -- single controller: ranks as threads ----------------------------------------


class Rendezvous:
    """Barrier exchange between the R rank threads of one ``Mesh.run``.

    ``exchange(rank, value)`` posts ``value`` and returns every rank's
    post once all have posted: one barrier per collective, the posts of
    consecutive collectives in alternate slot arrays (a rank can post the
    next collective's value only once every rank has arrived there, so
    nobody still reads the array it writes).  A failed rank (``abort``), a rank that
    returns while others wait at a collective (``finish``: the ranks
    disagree on the program) or a wait longer than ``timeout_s`` releases
    every waiting rank with ``RankAborted``, so no rank hangs."""

    def __init__(self, n: int, timeout_s: float):
        self.n = n
        self.timeout_s = timeout_s
        self.cond = threading.Condition()
        self.slots = ([None] * n, [None] * n)
        self.arrived = 0
        self.generation = 0
        self.finished = 0
        self.error: Optional[str] = None

    def _wait(self) -> None:
        gen = self.generation
        self.arrived += 1
        if self.arrived == self.n:
            self.arrived = 0
            self.generation += 1
            self.cond.notify_all()
            return
        while gen == self.generation:
            if self.error is None and self.finished:
                self.error = "a rank returned while others wait at a collective"
            if self.error is not None:
                self.cond.notify_all()
                raise RankAborted(self.error)
            if not self.cond.wait(self.timeout_s) and gen == self.generation:
                self.error = f"a collective waited {self.timeout_s:g}s for its ranks"

    def exchange(self, rank: int, value) -> list:
        with _turn_released(), self.cond:
            if self.error is not None:
                raise RankAborted(self.error)
            slots = self.slots[self.generation % 2]
            slots[rank] = value
            self._wait()
            return list(slots)

    def finish(self) -> None:
        with self.cond:
            self.finished += 1
            if self.arrived and self.error is None:
                self.error = "a rank returned while others wait at a collective"
                self.cond.notify_all()

    def abort(self, exc: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = f"rank failed: {type(exc).__name__}: {exc}"
            self.cond.notify_all()


# A fake mode is not thread-safe: while it runs an op it answers every
# fake tensor's ``.device`` with ``meta``, in every thread.  Rank threads
# that share the caller's fake mode therefore take turns: a rank holds the
# turn while it runs, and hands it on only while it waits at a collective.
_FAKE_TURN = threading.Lock()
_turn = threading.local()


@contextlib.contextmanager
def _fake_turn():
    with _FAKE_TURN:
        _turn.held = True
        try:
            yield
        finally:
            _turn.held = False


@contextlib.contextmanager
def _turn_released():
    """Hand the fake turn on while this rank waits (no-op without one)."""
    if not getattr(_turn, "held", False):
        yield
        return
    _turn.held = False
    _FAKE_TURN.release()
    try:
        yield
    finally:
        _FAKE_TURN.acquire()
        _turn.held = True


def run_rank(comm: "ThreadCommunicator", stream, fn, args, tags=None, fake=None,
             counter=None):
    """One rank's thread: its device and the caller's stream current, its
    communicator current, the caller's obs tags inherited (``tags``, when
    tracing), the caller's fake mode (``fake``: the ranks take turns, see
    ``_FAKE_TURN``) and cost counter (``counter``: counted as this rank's
    program), ``fn(*args)``; a failure releases the others."""
    try:
        with contextlib.ExitStack() as stack:
            if stream is not None:
                stack.enter_context(torch.cuda.device(comm.device))
                stack.enter_context(torch.cuda.stream(stream))
            if fake is not None:
                stack.enter_context(_fake_turn())
                stack.enter_context(fake)
            if counter is not None:
                stack.enter_context(hlo_stats.rank_scope(counter, comm.rank))
            stack.enter_context(current(comm))
            if tags is not None:
                stack.enter_context(obs.inherited(tags))
            out = fn(*args)
    except BaseException as e:
        comm.rendezvous.abort(e)
        raise
    comm.rendezvous.finish()
    return out


class ThreadCommunicator:
    """Rank ``rank`` of a single-controller ``Mesh``: its collectives are
    barrier exchanges with the other rank threads (module docstring)."""

    def __init__(self, mesh, rank: int, rendezvous: Rendezvous):
        self.mesh = mesh
        self.rank = rank
        self.device = mesh.device
        self.rendezvous = rendezvous

    def _receive(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, copy=True)

    def ppermute(self, x, axes, perm):
        group = self.mesh.group(self.rank, axes)
        view = self.rendezvous.exchange(self.rank, x)
        src = _source(perm, group.index(self.rank))
        if src is None:
            _count("ppermute", 0)
            return torch.zeros_like(x)
        if group[src] == self.rank:
            _count("ppermute", 0)
            return x
        got = view[group[src]]
        _count("ppermute", got.numel() * got.element_size())
        return self._receive(got)

    def all_gather(self, x, axes, *, axis, tiled):
        group = self.mesh.group(self.rank, axes)
        view = self.rendezvous.exchange(self.rank, x)
        # the concatenation is the copy each received shard takes
        parts = [view[g].to(self.device) for g in group]
        _count("all_gather", sum(p.numel() * p.element_size()
                                 for g, p in zip(group, parts) if g != self.rank))
        return _combine(parts, axis, tiled)

    def psum(self, x, axes):
        group = self.mesh.group(self.rank, axes)
        view = self.rendezvous.exchange(self.rank, x)
        acc = None
        for g in group:
            part = view[g].to(self.device)
            acc = part.clone() if acc is None else acc + part
        _count("psum", (len(group) - 1) * x.numel() * x.element_size())
        return acc


class SoloCommunicator:
    """One rank of a mesh run alone, to count its program (the cost
    counter's ``one_rank`` pricing): each collective returns an
    uninitialised tensor of its output's shape, and nothing moves.  Every
    rank of a planned product runs the same program on blocks of one
    shape, so one rank's ops are each rank's."""

    def __init__(self, mesh, rank: int = 0):
        self.mesh = mesh
        self.rank = rank
        self.device = mesh.device

    def ppermute(self, x, axes, perm):
        return torch.empty_like(x)

    def all_gather(self, x, axes, *, axis, tiled):
        g = self.mesh.axis_size(axes)
        shape = list(x.shape)
        if tiled:
            shape[axis] *= g
        else:
            shape.insert(axis, g)
        return x.new_empty(shape)

    def psum(self, x, axes):
        return torch.empty_like(x)


# -- process group: one rank per process ------------------------------------------


class ProcessGroupCommunicator:
    """This process's rank of a process-group ``Mesh`` over
    ``torch.distributed`` (initialised by the caller, world size = mesh
    size, world rank = mesh rank).  Subgroups are made on first use of an
    axis tuple, all of its groups at once in every process (``new_group``
    is collective over the world), which holds because every rank runs the
    same program."""

    def __init__(self, mesh):
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() != mesh.size \
                or dist.get_rank() != mesh.rank:
            raise RuntimeError(
                f"a process-group mesh of {mesh.size} ranks needs torch.distributed "
                f"initialised with that world size and rank {mesh.rank}")
        self.mesh = mesh
        self.rank = mesh.rank
        self.device = mesh.device
        self._groups: Dict[tuple, object] = {}

    def _subgroup(self, axes):
        import torch.distributed as dist

        if axes not in self._groups:
            mine = None
            for g in self.mesh.groups(axes):
                handle = dist.new_group(sorted(g))
                if self.rank in g:
                    mine = handle
            self._groups[axes] = mine
        return self._groups[axes]

    def ppermute(self, x, axes, perm):
        import torch.distributed as dist

        group = self.mesh.group(self.rank, axes)
        me = group.index(self.rank)
        x = x.contiguous()
        ops = []
        for src, dst in perm:
            if src == me and dst != me:
                ops.append(dist.P2POp(dist.isend, x, group[dst]))
        src = _source(perm, me)
        if src is None:
            out = torch.zeros_like(x)
        elif src == me:
            out = x
        else:
            out = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, out, group[src]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        _count("ppermute", 0 if src is None or src == me else out.numel() * out.element_size())
        return out

    def all_gather(self, x, axes, *, axis, tiled):
        import torch.distributed as dist

        group = self.mesh.group(self.rank, axes)
        x = x.contiguous()
        buf = torch.empty((len(group) * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(buf, x, group=self._subgroup(axes))
        # the subgroup orders its members by world rank; put them in group order
        by_rank = dict(zip(sorted(group), buf.view((len(group),) + tuple(x.shape)).unbind(0)))
        _count("all_gather", (len(group) - 1) * x.numel() * x.element_size())
        return _combine([by_rank[g] for g in group], axis, tiled)

    def psum(self, x, axes):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=self._subgroup(axes))
        _count("psum", (self.mesh.axis_size(axes) - 1) * x.numel() * x.element_size())
        return out
