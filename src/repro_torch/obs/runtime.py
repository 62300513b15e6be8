"""Span recorder: hierarchical, context-propagated, zero-dependency.

Port of ``repro.obs.runtime`` (no JAX in it; the port keeps its own copy).
The process-global :class:`Recorder` collects three event kinds:

  spans        -- ``with span("plan.build", m=..., n=...):`` blocks; nesting
                  is tracked per thread (a thread-local stack), and every
                  span inherits the *tags* of its ancestors so a collective
                  recorded three layers under ``plan.execute`` still knows
                  which strategy it belongs to.
  collectives  -- one :class:`CollectiveEvent` per data-movement call routed
                  through the ``repro_torch.dist._collectives`` seam, keyed
                  exactly like ``repro_torch.verify.trace.CollectiveRecord``
                  (kind, group, shard words, canonical perm) so the obs
                  multiset is comparable to the conformance interceptor's.
  instants     -- point annotations (cache hits, ranking decisions).

The reference records a collective once, while shard_map traces its body.
Here every rank of a per-rank program calls the seam at run time, each in
a thread of its own on a single-controller mesh: the seam records from the
lowest local rank only (the rank whose sequence the interceptor takes as
the program's), and a rank thread starts from the tags of the caller's
span stack (``inherited``), as ``Mesh.run`` forks its streams from the
caller's.

Every span has an ``id`` and the ``parent`` id of the span that opened it
on its thread, and carries the ``batch`` tag of the nearest enclosing span
that has one (``serve.generate`` tags each served batch).  While enabled,
a span is also a ``torch.profiler.record_function`` range of its name, and
its timestamps are read on the profiler's own clock (``CLOCK_REALTIME``,
``time.time_ns``), so ``write_trace`` output lays over a profiler trace
(whose chrome export counts from its ``baseTimeNanoseconds``).
A range holds the host calls that launch its kernels; the profiler's
device-side annotation of a kernel goes to the innermost range only, so an
outer span's device time is read through its launches (their correlation
ids), not from its annotation.

Inside a CUDA-graph capture opened under ``graph_events()``, each span
named ``model.*`` or ``layer.*`` (``DEVICE_TIMED``) also records a timing
event at its entry and exit on the capturing stream
(``torch.cuda.Event(enable_timing=True, external=True)``): the events are
nodes of the graph, every replay records them again, and
``graph_times_us`` reads one replay's device time by span name.  A
capture made with tracing off holds no such node.

Disabled mode (the default) is a no-op fast path: ``span()`` returns a
shared singleton context manager after one module-global read, with no
profiler range, no event and no allocation, and every instrumentation
site guards on ``enabled()`` before touching the recorder or the device.
``observe()`` is the scoped enable used by tests, the drift check and
``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

Perm = Tuple[Tuple[int, int], ...]

_ENABLED = False
# spans whose device time a CUDA-graph capture records (``graph_events``)
DEVICE_TIMED = ("model.", "layer.")
_IDS = itertools.count(1)


def enabled() -> bool:
    """True when the observability layer is recording (module-global flag;
    the one check every instrumentation site pays when tracing is off)."""
    return _ENABLED


def enable() -> None:
    """Turn span/collective recording on (process-global)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn recording off; already-captured events stay in the recorder."""
    global _ENABLED
    _ENABLED = False


def _now_us() -> float:
    """Microseconds on the clock ``torch.profiler`` stamps its events with
    (``CLOCK_REALTIME``; ``tests/test_torch_tracing.py`` pins it)."""
    return time.time_ns() / 1e3


def canonical_perm(perm) -> Perm:
    """Sorted non-identity (src, dst) pairs -- the same comparable form
    ``repro_torch.verify.trace.canonical_perm`` uses (duplicated here so
    the dist seam never imports the verify package)."""
    return tuple(sorted(
        (int(s), int(d)) for s, d in perm if int(s) != int(d)))


@dataclasses.dataclass
class SpanRecord:
    """One finished span: a Perfetto complete ("X") event, its own ``id``,
    the ``parent`` id of the span that opened it on its thread (None at
    the top) and the ``batch`` tag it runs under (None outside one)."""

    name: str
    ts_us: float
    dur_us: float
    tid: int
    depth: int
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    id: int = 0
    parent: Optional[int] = None
    batch: Any = None


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One data-movement collective seen at the dist seam.

    ``key`` matches ``repro_torch.verify.trace.CollectiveRecord.key``, so
    ``Counter(ev.key for ev in recorder.collectives)`` is directly
    comparable to the conformance interceptor's multiset.
    """

    kind: str                     # "ppermute" | "all_gather" | "psum"
    group: int
    shard_words: int
    perm: Optional[Perm] = None   # canonical, ppermute only
    strategy: str = ""            # ambient span tag at record time
    comm: str = "exposed"         # "hidden" when issued as a prefetch
    ts_us: float = 0.0
    tid: int = 0

    @property
    def key(self) -> Tuple:
        return (self.kind, self.group, self.shard_words, self.perm)


class Recorder:
    """Thread-safe process-global sink for spans/collectives/instants."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans: List[SpanRecord] = []
        self.collectives: List[CollectiveEvent] = []
        self.instants: List[Tuple[str, float, int, Dict[str, Any]]] = []

    def add_span(self, rec: SpanRecord) -> None:
        with self._lock:
            self.spans.append(rec)

    def add_collective(self, ev: CollectiveEvent) -> None:
        with self._lock:
            self.collectives.append(ev)

    def add_instant(self, name: str, **args) -> None:
        with self._lock:
            self.instants.append(
                (name, _now_us(), threading.get_ident(), args))

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.collectives.clear()
            self.instants.clear()

    def span_counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for s in self.spans:
                out[s.name] = out.get(s.name, 0) + 1
            return out


_RECORDER = Recorder()
_TLS = threading.local()


def get_recorder() -> Recorder:
    """The process-global recorder (one per process, like the metrics
    registry -- exporters read it, ``reset()`` clears it)."""
    return _RECORDER


def reset() -> None:
    """Clear all recorded spans/collectives/instants (counters live in
    ``repro_torch.obs.metrics`` and have their own reset)."""
    _RECORDER.clear()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current_tags() -> Dict[str, Any]:
    """Merged args of the active span stack on this thread (innermost
    wins), over the tags the thread inherited (``inherited``) -- how the
    collective seam learns the executing strategy."""
    tags: Dict[str, Any] = dict(getattr(_TLS, "base", None) or {})
    for frame in _stack():
        tags.update(frame.args)
    return tags


@contextlib.contextmanager
def inherited(tags: Dict[str, Any]):
    """Within the scope, the calling thread's spans and collectives start
    from ``tags``: a rank thread of ``Mesh.run`` takes the caller's
    ``current_tags()`` this way."""
    prev = getattr(_TLS, "base", None)
    _TLS.base = dict(tags)
    try:
        yield
    finally:
        _TLS.base = prev


class _Frame:
    """One entered span on its thread's stack."""

    __slots__ = ("name", "args", "id", "parent", "batch", "t0", "range", "events")

    def __init__(self, name: str, args: Dict[str, Any], up: Optional["_Frame"]):
        self.name = name
        self.args = args
        self.id = next(_IDS)
        self.parent = up.id if up is not None else None
        inherited_batch = (up.batch if up is not None
                           else (getattr(_TLS, "base", None) or {}).get("batch"))
        self.batch = args.get("batch", inherited_batch)
        self.events = None


class _Span:
    """Active span handle; re-entrant per ``with`` (one frame per enter)."""

    __slots__ = ("name", "args")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args

    def __enter__(self):
        st = _stack()
        frame = _Frame(self.name, self.args, st[-1] if st else None)
        log = getattr(_TLS, "graph_log", None)
        if log is not None and self.name.startswith(DEVICE_TIMED):
            frame.events = _record_event()
        frame.t0 = _now_us()
        frame.range = _record_function(self.name)
        frame.range.__enter__()
        st.append(frame)
        return self

    def __exit__(self, *exc):
        st = _stack()
        frame = st.pop()
        if frame.events is not None:
            _TLS.graph_log.append((frame.name, frame.events, _record_event()))
        frame.range.__exit__(None, None, None)
        _RECORDER.add_span(SpanRecord(
            name=frame.name, ts_us=frame.t0, dur_us=_now_us() - frame.t0,
            tid=threading.get_ident(), depth=len(st), args=frame.args,
            id=frame.id, parent=frame.parent, batch=frame.batch))
        return False


def _record_function(name: str):
    from torch.profiler import record_function

    return record_function(name)


def _record_event():
    """A timing event recorded on the current stream; inside a capture it
    becomes a node of the graph (``external``)."""
    import torch

    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


class _NoopSpan:
    """Shared disabled-mode singleton: enter/exit allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


def span(name: str, **args):
    """Context manager recording one hierarchical span.

        with obs.span("plan.build", strategy="cannon"):
            ...

    Args become the span's Perfetto ``args`` and are inherited as ambient
    tags by everything recorded inside (see ``current_tags``).  When
    recording is disabled this returns a shared no-op singleton.
    """
    if not _ENABLED:
        return NOOP_SPAN
    return _Span(name, args)


@contextlib.contextmanager
def graph_events():
    """Around a CUDA-graph capture on this thread: with tracing on, every
    ``DEVICE_TIMED`` span entered inside records a timing event at its
    entry and exit on the capturing stream (module docstring).  Yields
    the list the capture fills with ``(name, start, end)``; it stays empty
    with tracing off."""
    log: List = []
    prev = getattr(_TLS, "graph_log", None)
    _TLS.graph_log = log if _ENABLED else None
    try:
        yield log
    finally:
        _TLS.graph_log = prev


def graph_times_us(log) -> Dict[str, float]:
    """The device microseconds of the last replay of a graph whose capture
    filled ``log`` (``graph_events``), summed by span name.  The replay
    must have finished on the device."""
    out: Dict[str, float] = {}
    for name, start, end in log:
        out[name] = out.get(name, 0.0) + start.elapsed_time(end) * 1e3
    return out


def record_collective(kind: str, group: int, shard_words: int,
                      perm=None) -> None:
    """Record one collective at the dist seam (no-op when disabled).
    ``perm`` is canonicalized; the executing strategy and the
    exposed/hidden classification (``comm="hidden"`` inside the
    double-buffered bodies' prefetch spans) are read off the ambient span
    tags."""
    if not _ENABLED:
        return
    tags = current_tags()
    _RECORDER.add_collective(CollectiveEvent(
        kind=kind, group=int(group), shard_words=int(shard_words),
        perm=canonical_perm(perm) if perm is not None else None,
        strategy=str(tags.get("strategy", "")),
        comm=str(tags.get("comm", "exposed")),
        ts_us=_now_us(), tid=threading.get_ident()))


def instant(name: str, **args) -> None:
    """Record a point annotation (no-op when disabled)."""
    if not _ENABLED:
        return
    _RECORDER.add_instant(name, **args)


@contextlib.contextmanager
def observe(fresh: bool = True):
    """Scoped recording: enable, (optionally) reset the recorder, yield it,
    then restore the previous enabled state.  The idiom for tests, the
    drift check and ``chip_smoke.py``:

        with obs.observe() as rec:
            execute_plan(plan, a, b)
        counts = collective_multiset(rec)
    """
    global _ENABLED
    prev = _ENABLED
    if fresh:
        _RECORDER.clear()
    _ENABLED = True
    try:
        yield _RECORDER
    finally:
        _ENABLED = prev
