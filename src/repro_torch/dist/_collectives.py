"""Interceptable collective seam for the per-rank programs.

Counterpart of ``repro.dist._collectives``.  Every word a lowered schedule
moves goes through ``ppermute`` (or its deferred form, ``ppermute_start``
and ``ppermute_done``), ``all_gather`` or ``psum`` here (the names
``repro_torch.verify.interceptor`` patches); ``axis_index`` and
``axis_size`` answer a rank's place on the mesh, as ``lax.axis_index`` and
``lax.psum(1, axis)`` do inside the reference's shard_map bodies, and
``rank`` the calling rank's number.  Each call goes to the communicator of
the rank the calling thread runs (``current``), one of two:

* ``ThreadCommunicator`` -- the single controller: the mesh's ranks are
  threads of one process, and a collective is a barrier exchange over a
  shared ``Rendezvous``: each rank posts its tensor, all wait, each takes
  what it receives.  On a CUDA mesh each rank runs on a compute stream and
  a copy stream of its own (``RankStreams``, made once per mesh and rank
  by ``Mesh.run``).  A rank posts its tensor with an event recorded on its
  compute stream after the kernel that wrote it.  A ppermute's copy waits
  on that event and runs on the receiver's copy stream, a
  ``cudaMemcpyAsync`` into a block allocated on the receiver's compute
  stream (the copy also waits for that stream's earlier use of the
  block); the receiver's compute stream waits on the copy's event only at
  ``ppermute_done``, where the tensor is first used.
  ``psum`` and ``all_gather`` read the posted tensors on the compute
  stream, after waiting on their events.  A rank keeps every tensor it
  read from another rank until its program ends, when the caller's stream
  waits on all of its work, so the caching allocator cannot hand the
  block out again under the read.  On the CPU and under a fake mode there
  are no streams: each copy is made at once.
* ``ProcessGroupCommunicator`` -- one rank per process over
  ``torch.distributed``: ``ppermute`` is ``batch_isend_irecv`` (started by
  ``ppermute_start``, waited on by ``ppermute_done``: on NCCL the wait
  holds back the stream, not the host), ``all_gather`` an all-gather into
  one tensor on the axis' subgroup, ``psum`` an ``all_reduce`` on it.

Semantics follow ``jax.lax``: ``perm`` pairs are (source, destination)
positions in the group over the named axes (``Mesh.axis_index``); a rank
no pair sends to receives zeros; ``all_gather`` stacks the group's tensors
in group order, or concatenates them along ``axis`` when ``tiled``;
``psum`` gives every member the sum (in group order).

``ppermute_start`` is the counterpart of XLA's ``collective-permute-start``:
it returns a ``PermuteHandle`` at once, and ``ppermute_done`` gives the
received tensor (``collective-permute-done``).  A program that returns
with a handle not finished raises, and so does a handle finished twice.
``ppermute`` is a start and its done at once.  A deferred ppermute is
counted once, as one ppermute, by everything below and by the
interceptor.

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
multiset.  The interceptor patches the seam's names and calls these, so
both see the same calls when active together.
"""
from __future__ import annotations

import contextlib
import ctypes
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
    """Make ``comm`` the calling thread's communicator within the scope;
    a deferred ppermute started in it and not finished when it ends
    without an error raises."""
    prev = getattr(_local, "comm", None), getattr(_local, "open", None)
    _local.comm, _local.open = comm, set()
    try:
        yield comm
        if _local.open:
            raise RuntimeError(f"{len(_local.open)} deferred ppermute(s) of this program "
                               f"were started and never finished (ppermute_done)")
    finally:
        _local.comm, _local.open = prev


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
        return comm.ppermute_start(x, axes, perm).wait()


class PermuteHandle:
    """A started ppermute (``ppermute_start``); ``ppermute_done`` finishes
    it, once."""

    __slots__ = ("_pending", "_done")

    def __init__(self, pending):
        self._pending = pending
        self._done = False


def ppermute_start(x: torch.Tensor, axis_name, perm) -> PermuteHandle:
    """Start ``ppermute(x, axis_name, perm)`` and return at once: on a CUDA
    thread mesh the copy is queued on this rank's copy stream, in a process
    group the sends and receives are issued.  ``ppermute_done`` gives the
    received tensor."""
    comm, axes = _comm(), as_axes(axis_name)
    if obs.enabled():
        _observe(comm, "ppermute", x, axes, perm)
    with hlo_stats.collective("ppermute", x, x.numel()):
        handle = PermuteHandle(comm.ppermute_start(x, axes, perm))
    _local.open.add(handle)
    return handle


def ppermute_done(handle: PermuteHandle) -> torch.Tensor:
    """The tensor a ``ppermute_start`` receives, for use on this rank's
    compute stream (which waits for the copy, not the host)."""
    if handle._done:
        raise RuntimeError("ppermute_done: this deferred ppermute was already finished")
    handle._done = True
    _local.open.discard(handle)
    return handle._pending.wait()


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


class _Ready:
    """A ppermute whose result is already there."""

    def __init__(self, out: torch.Tensor):
        self.out = out

    def wait(self) -> torch.Tensor:
        return self.out


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


# Events each rank keeps for the ppermute copies in flight at once (an
# overlapped body has at most two); more are made outside a capture only.
COPY_EVENTS = 4

# The per-collective event records and waits (the CUDA driver's) and
# copies (PyTorch's CUDA runtime's, so a profile sees them as it sees
# PyTorch's) are called through ``ctypes.PyDLL``, which keeps the
# interpreter lock: each is a microsecond's call.  PyTorch's bindings
# release the lock for each, and the rank threads, woken together by every
# barrier, then queue for it at every call, which costs more than the calls
# (``probe_links``' α of a rank-thread ppermute shows it).
_driver = None
_runtime = None
_DEVICE_TO_DEVICE = 3     # cudaMemcpyDeviceToDevice


def _cu():
    global _driver
    if _driver is None:
        lib = ctypes.PyDLL("libcuda.so.1")
        lib.cuEventRecord.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
        lib.cuEventRecord.restype = ctypes.c_int
        lib.cuStreamWaitEvent.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint)
        lib.cuStreamWaitEvent.restype = ctypes.c_int
        _driver = lib
    return _driver


def _cudart():
    global _runtime
    if _runtime is None:
        lib = ctypes.PyDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
        lib.cudaMemcpyAsync.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_int, ctypes.c_void_p)
        lib.cudaMemcpyAsync.restype = ctypes.c_int
        _runtime = lib
    return _runtime


def _record(event: "torch.cuda.Event", stream: "torch.cuda.Stream") -> None:
    rc = _cu().cuEventRecord(event.cuda_event, stream.cuda_stream)
    if rc:
        raise RuntimeError(f"cuEventRecord failed ({rc})")


def _wait(stream: "torch.cuda.Stream", event: "torch.cuda.Event") -> None:
    rc = _cu().cuStreamWaitEvent(stream.cuda_stream, event.cuda_event, 0)
    if rc:
        raise RuntimeError(f"cuStreamWaitEvent failed ({rc})")


class RankStreams:
    """One rank's CUDA streams and events on a single-controller mesh (the
    module docstring), made once per mesh and rank outside any capture:
    the compute stream its program runs on, a copy stream (of high
    priority: copies are short and the compute waits on them), the events
    of its posts (two, by collective parity: a rank posts again only once
    every rank has passed the collective before, by which time every
    receiver has queued its wait on the older post), of its copies in
    flight, of the end of its program, and a mark of its compute stream
    for the copy stream to wait on."""

    def __init__(self, device: torch.device):
        self.device = device
        self.compute = torch.cuda.Stream(device)
        self.copy = torch.cuda.Stream(device, priority=-1)
        self.posts = (self._event(), self._event())
        self.end = self._event()
        self.mark = self._event()
        self._copies = [self._event() for _ in range(COPY_EVENTS)]

    def _event(self) -> torch.cuda.Event:
        ev = torch.cuda.Event()
        ev.record(self.compute)   # made now (CUDA events are made at first record)
        return ev

    def copy_in(self, src: torch.Tensor, src_posted) -> "_Copying":
        """Queue a copy of ``src`` on the copy stream into a block allocated
        on the compute stream, after the source's post and after the
        compute stream's earlier use of the block (the mark).  A contiguous
        source is one ``cudaMemcpyAsync``; another is PyTorch's copy on the
        copy stream."""
        out = torch.empty_like(src, memory_format=torch.contiguous_format)
        _record(self.mark, self.compute)
        _wait(self.copy, self.mark)
        _wait(self.copy, src_posted)
        if src.is_contiguous():
            rc = _cudart().cudaMemcpyAsync(out.data_ptr(), src.data_ptr(),
                                           src.numel() * src.element_size(),
                                           _DEVICE_TO_DEVICE, self.copy.cuda_stream)
            if rc:
                raise RuntimeError(f"cudaMemcpyAsync failed ({rc})")
        else:
            with torch.cuda.stream(self.copy):
                out.copy_(src)
        if not self._copies:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"more than {COPY_EVENTS} deferred ppermutes in flight "
                                   f"inside a CUDA graph capture")
            self._copies.append(self._event())
        ev = self._copies.pop()
        _record(ev, self.copy)
        return _Copying(out, ev, self)


class _Copying:
    """A ppermute copy queued on a rank's copy stream."""

    def __init__(self, out: torch.Tensor, event, streams: RankStreams):
        self.out, self.event, self.streams = out, event, streams

    def wait(self) -> torch.Tensor:
        _wait(self.streams.compute, self.event)
        self.streams._copies.append(self.event)
        return self.out


def run_rank(comm: "ThreadCommunicator", stream, fn, args, tags=None, fake=None,
             counter=None, fork=None):
    """One rank's thread: its device current and its stream (its own
    compute stream after it waits on ``fork``, the caller's stream at the
    run's start, where ``comm`` has ``RankStreams``; else ``stream``, the
    caller's), its communicator current, the caller's obs tags inherited
    (``tags``, when tracing), the caller's fake mode (``fake``: the ranks
    take turns, see ``_FAKE_TURN``) and cost counter (``counter``: counted
    as this rank's program), ``fn(*args)``; a failure releases the others.
    With ``RankStreams`` the end of the program is recorded on its compute
    stream, failed or not, for the caller to wait on."""
    own = comm.streams
    try:
        with contextlib.ExitStack() as stack:
            if own is not None:
                stack.enter_context(torch.cuda.device(comm.device))
                stack.enter_context(torch.cuda.stream(own.compute))
                stack.callback(own.end.record, own.compute)
                own.compute.wait_event(fork)
            elif stream is not None:
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
    barrier exchanges with the other rank threads, on its ``RankStreams``
    where it has them (module docstring)."""

    def __init__(self, mesh, rank: int, rendezvous: Rendezvous,
                 streams: Optional[RankStreams] = None):
        self.mesh = mesh
        self.rank = rank
        self.device = mesh.device
        self.rendezvous = rendezvous
        self.streams = streams
        self._posts = 0
        self._kept: list = []    # other ranks' tensors this rank read (module docstring)

    def _post(self, x: torch.Tensor) -> list:
        """Post ``x`` with the event of its writing (None without streams);
        every rank's (tensor, event)."""
        event = None
        if self.streams is not None:
            event = self.streams.posts[self._posts % 2]
            _record(event, self.streams.compute)
        self._posts += 1
        return self.rendezvous.exchange(self.rank, (x, event))

    def _read(self, view, group) -> list:
        """The group's posted tensors, each readable on this rank's compute
        stream."""
        parts = []
        for g in group:
            t, event = view[g]
            if g != self.rank and self.streams is not None:
                _wait(self.streams.compute, event)
                self._kept.append(t)
            parts.append(t.to(self.device))
        return parts

    def ppermute_start(self, x, axes, perm):
        group = self.mesh.group(self.rank, axes)
        src = _source(perm, group.index(self.rank))
        src_rank = None if src is None else group[src]
        view = self._post(x)
        if src_rank is None:
            _count("ppermute", 0)
            return _Ready(torch.zeros_like(x))
        if src_rank == self.rank:
            _count("ppermute", 0)
            return _Ready(x)
        got, event = view[src_rank]
        _count("ppermute", got.numel() * got.element_size())
        if self.streams is None:
            return _Ready(got.to(self.device, copy=True))
        self._kept.append(got)
        return self.streams.copy_in(got, event)

    def all_gather(self, x, axes, *, axis, tiled):
        group = self.mesh.group(self.rank, axes)
        # the concatenation is the copy each received shard takes
        parts = self._read(self._post(x), group)
        _count("all_gather", sum(p.numel() * p.element_size()
                                 for g, p in zip(group, parts) if g != self.rank))
        return _combine(parts, axis, tiled)

    def psum(self, x, axes):
        group = self.mesh.group(self.rank, axes)
        acc = None
        for part in self._read(self._post(x), group):
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

    def ppermute_start(self, x, axes, perm):
        return _Ready(torch.empty_like(x))

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

    def ppermute_start(self, x, axes, perm):
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
        reqs = dist.batch_isend_irecv(ops) if ops else []
        _count("ppermute", 0 if src is None or src == me else out.numel() * out.element_size())
        return _Requests(reqs, out, x)

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


class _Requests:
    """A ppermute's sends and receives in flight over the process group;
    the sent tensor is held until they are done."""

    def __init__(self, reqs, out: torch.Tensor, sent: torch.Tensor):
        self.reqs, self.out, self.sent = reqs, out, sent

    def wait(self) -> torch.Tensor:
        for req in self.reqs:
            req.wait()
        self.sent = None
        return self.out
