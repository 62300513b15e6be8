"""repro_torch.obs -- observability: spans, metrics, machine profiles.

Port of ``repro.obs``, the measured leg of the repo's measured-vs-analytic
loop.  ``repro_torch.verify`` proves the executed programs move exactly the
analytic number of words; this package measures what the card does with
them:

  runtime    -- hierarchical span tracing (``span("plan.build")``),
                context-propagated tags (inherited by the rank threads of
                a single-controller mesh), a process-global recorder, and a
                no-op fast path when disabled (the default); an enabled
                span is a ``torch.profiler`` range on the profiler's clock,
                and inside a captured CUDA graph a ``model.*`` / ``layer.*``
                span is a pair of timing events (``graph_events``)
  metrics    -- typed counters/histograms (plan-cache hits, per-strategy
                collective counts/words, kernel device time)
  export     -- Chrome/Perfetto ``trace_event`` JSON + the flat metrics
                JSON; ``collective_multiset`` is comparable to the
                ``repro_torch.verify`` interceptor's records
  profile    -- versioned :class:`MachineProfile` (fitted α–β per link
                class + measured peak FLOPs, optionally a tuning table);
                ``build_plan(profile=...)`` ranks strategies with
                calibrated seconds while the word counts stay analytic
  calibrate  -- ``probe_links(mesh)``: the microbenchmark pass that fits
                a profile on the card (``repro_torch.launch.perf_probe``
                writes it to disk)

Nothing here touches the device at import; enabling tracing costs one
module-global check per instrumentation site when off.
"""
from . import calibrate, export, metrics, profile, runtime
from .calibrate import probe_links
from .export import (SCHEMA_VERSION, collective_multiset, collective_totals,
                     metrics_snapshot, to_trace_events, write_metrics,
                     write_trace)
from .metrics import (Counter, Histogram, counter, histogram, reset_metrics,
                      snapshot)
from .profile import (PROFILE_SCHEMA, LinkParams, MachineProfile,
                      default_profile, fit_alpha_beta, load_profile,
                      save_profile)
from .runtime import (NOOP_SPAN, CollectiveEvent, Recorder, SpanRecord,
                      current_tags, disable, enable, enabled, get_recorder,
                      graph_events, graph_times_us, inherited, instant,
                      observe, record_collective, reset, span)

__all__ = [
    "calibrate", "export", "metrics", "profile", "runtime",
    # runtime
    "enable", "disable", "enabled", "observe", "span", "instant",
    "record_collective", "current_tags", "inherited", "get_recorder", "reset",
    "Recorder", "SpanRecord", "CollectiveEvent", "NOOP_SPAN",
    "graph_events", "graph_times_us",
    # metrics
    "Counter", "Histogram", "counter", "histogram", "reset_metrics",
    "snapshot",
    # export
    "SCHEMA_VERSION", "to_trace_events", "write_trace", "metrics_snapshot",
    "write_metrics", "collective_multiset", "collective_totals",
    # profile + calibration
    "PROFILE_SCHEMA", "LinkParams", "MachineProfile", "default_profile",
    "fit_alpha_beta", "load_profile", "save_profile", "probe_links",
]
