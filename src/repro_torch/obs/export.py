"""Exporters: Chrome/Perfetto ``trace_event`` JSON and flat metrics JSON.

Copy of ``repro.obs.export`` (no JAX in it; the port keeps its own).

``to_trace_events`` renders the recorder into the trace-event format both
``chrome://tracing`` and https://ui.perfetto.dev load directly: spans as
complete ("X") events, collectives and instants as thread-scoped instant
("i") events.  ``metrics_snapshot`` merges the metrics registry with
per-strategy collective totals into one flat dict, versioned with
``SCHEMA_VERSION`` so downstream readers can evolve safely.
"""
from __future__ import annotations

import json
import os
from collections import Counter as _Counter
from typing import Any, Dict, Optional

from . import metrics as _metrics
from .runtime import Recorder, get_recorder

SCHEMA_VERSION = 1
_PID = os.getpid()


def to_trace_events(recorder: Optional[Recorder] = None) -> Dict[str, Any]:
    """Render ``recorder`` (default: the global one) as a Perfetto-loadable
    trace_event JSON object."""
    rec = recorder if recorder is not None else get_recorder()
    events = []
    for s in rec.spans:
        events.append({
            "name": s.name, "cat": "obs", "ph": "X",
            "ts": s.ts_us, "dur": s.dur_us,
            "pid": _PID, "tid": s.tid,
            "args": {k: _jsonable(v) for k, v in s.args.items()},
        })
    for ev in rec.collectives:
        events.append({
            "name": f"collective.{ev.kind}", "cat": "collective", "ph": "i",
            "ts": ev.ts_us, "pid": _PID, "tid": ev.tid, "s": "t",
            "args": {
                "strategy": ev.strategy, "group": ev.group,
                "shard_words": ev.shard_words,
                "perm_pairs": len(ev.perm) if ev.perm is not None else None,
                "comm": ev.comm,
            },
        })
    for name, ts, tid, args in rec.instants:
        events.append({
            "name": name, "cat": "obs", "ph": "i", "ts": ts,
            "pid": _PID, "tid": tid, "s": "t",
            "args": {k: _jsonable(v) for k, v in args.items()},
        })
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"schema": SCHEMA_VERSION, "producer": "repro_torch.obs"},
    }


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def write_trace(path: str, recorder: Optional[Recorder] = None) -> str:
    """Write the trace_event JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(to_trace_events(recorder), f, indent=1)
    return path


def collective_multiset(recorder: Optional[Recorder] = None,
                        strategy: Optional[str] = None) -> _Counter:
    """Multiset of collective keys ``(kind, group, shard_words, perm)`` --
    the exact comparison form of ``repro_torch.verify``
    (``CollectiveRecord.key`` / ``compare_records``).  ``strategy`` filters on the ambient tag."""
    rec = recorder if recorder is not None else get_recorder()
    return _Counter(ev.key for ev in rec.collectives
                    if strategy is None or ev.strategy == strategy)


def collective_totals(recorder: Optional[Recorder] = None) -> Dict[str, Dict]:
    """Per-strategy per-kind collective counts and shard words.

    ``hidden_words`` counts the subset issued as double-buffer prefetches
    (``comm == "hidden"``); ``shard_words - hidden_words`` is the exposed
    communication the overlap could not hide."""
    rec = recorder if recorder is not None else get_recorder()
    out: Dict[str, Dict] = {}
    for ev in rec.collectives:
        strat = out.setdefault(ev.strategy or "(untagged)", {})
        kind = strat.setdefault(ev.kind, {"count": 0, "shard_words": 0,
                                          "hidden_words": 0})
        kind["count"] += 1
        kind["shard_words"] += ev.shard_words
        if ev.comm == "hidden":
            kind["hidden_words"] += ev.shard_words
    return out


def metrics_snapshot(recorder: Optional[Recorder] = None) -> Dict[str, Any]:
    """The flat metrics JSON: registry snapshot + span counts + collective
    totals, under one schema-versioned envelope."""
    rec = recorder if recorder is not None else get_recorder()
    return {
        "schema": SCHEMA_VERSION,
        "metrics": _metrics.snapshot(),
        "spans": rec.span_counts(),
        "collectives": collective_totals(rec),
    }


def write_metrics(path: str, recorder: Optional[Recorder] = None) -> str:
    """Write the flat metrics JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(metrics_snapshot(recorder), f, indent=1, sort_keys=True)
    return path
