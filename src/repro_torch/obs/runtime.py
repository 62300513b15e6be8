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
span stack (``inherited``), as ``Mesh.run`` hands it the caller's stream.

Disabled mode (the default) is a no-op fast path: ``span()`` returns a
shared singleton context manager that allocates nothing, and every
instrumentation site guards on ``enabled()`` (one module-global read)
before touching the recorder or the device.  ``observe()`` is the scoped
enable used by tests, the drift check and ``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

Perm = Tuple[Tuple[int, int], ...]

_ENABLED = False


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
    return time.perf_counter_ns() / 1e3


def canonical_perm(perm) -> Perm:
    """Sorted non-identity (src, dst) pairs -- the same comparable form
    ``repro_torch.verify.trace.canonical_perm`` uses (duplicated here so
    the dist seam never imports the verify package)."""
    return tuple(sorted(
        (int(s), int(d)) for s, d in perm if int(s) != int(d)))


@dataclasses.dataclass
class SpanRecord:
    """One finished span: a Perfetto complete ("X") event."""

    name: str
    ts_us: float
    dur_us: float
    tid: int
    depth: int
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


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
    for _, _, args in _stack():
        tags.update(args)
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


class _Span:
    """Active span handle; re-entrant per ``with`` (one handle per enter)."""

    __slots__ = ("name", "args")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args

    def __enter__(self):
        _stack().append((self.name, _now_us(), self.args))
        return self

    def __exit__(self, *exc):
        name, t0, args = _stack().pop()
        _RECORDER.add_span(SpanRecord(
            name=name, ts_us=t0, dur_us=_now_us() - t0,
            tid=threading.get_ident(), depth=len(_stack()), args=args))
        return False


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
