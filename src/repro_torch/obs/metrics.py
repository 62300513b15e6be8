"""Typed counters and histograms with a process-global registry.

Copy of ``repro.obs.metrics`` (no JAX in it; the port keeps its own).
Instrumentation sites guard on ``repro_torch.obs.enabled()`` before
recording, so the registry only fills while tracing is on; direct use
(tests, ``chip_smoke.py``) works regardless.  ``snapshot()`` flattens
everything into the flat metrics JSON.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple


class Counter:
    """Monotonic labeled counter: ``counter("plan.cache.hit").inc()`` or
    ``counter("dist.collective.bytes").inc(n, kind="ppermute")``.  Values
    are kept per label set (sorted key=value pairs)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}

    @staticmethod
    def _key(labels: Dict[str, Any]) -> Tuple:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def inc(self, value: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def items(self):
        with self._lock:
            return dict(self._values)


class Histogram:
    """Streaming summary (count/sum/min/max) -- enough for build-µs and
    kernel wall-time distributions without storing every sample."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def summary(self) -> Dict[str, Optional[float]]:
        with self._lock:
            mean = self.sum / self.count if self.count else None
            return {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max, "mean": mean}


_LOCK = threading.Lock()
_COUNTERS: Dict[str, Counter] = {}
_HISTOGRAMS: Dict[str, Histogram] = {}


def counter(name: str) -> Counter:
    """Get-or-create the named process-global counter."""
    with _LOCK:
        c = _COUNTERS.get(name)
        if c is None:
            c = _COUNTERS[name] = Counter(name)
        return c


def histogram(name: str) -> Histogram:
    """Get-or-create the named process-global histogram."""
    with _LOCK:
        h = _HISTOGRAMS.get(name)
        if h is None:
            h = _HISTOGRAMS[name] = Histogram(name)
        return h


def reset_metrics() -> None:
    """Drop every registered counter and histogram."""
    with _LOCK:
        _COUNTERS.clear()
        _HISTOGRAMS.clear()


def snapshot() -> Dict[str, Any]:
    """Flatten the registry: ``{name: total}`` for unlabeled counters,
    ``{name{k=v,...}: value}`` per label set otherwise, and the
    count/sum/min/max/mean summary per histogram."""
    out: Dict[str, Any] = {}
    with _LOCK:
        counters = list(_COUNTERS.values())
        hists = list(_HISTOGRAMS.values())
    for c in counters:
        items = c.items()
        for key, val in sorted(items.items()):
            if not key:
                out[c.name] = val
            else:
                lbl = ",".join(f"{k}={v}" for k, v in key)
                out[f"{c.name}{{{lbl}}}"] = val
    for h in hists:
        out[h.name] = h.summary()
    return out
