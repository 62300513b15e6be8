"""repro_torch.verify -- trace-level conformance for executed schedules.

Port of ``repro.verify``.  The paper's claim is that equivariant maps *are*
schedules with provable time and communication costs; this package
machine-checks it for every program the port executes, via three
independent derivations of the same communication:

  trace        -- a tracing interpreter replaying any ``SchedulePlan`` on a
                  virtual topology (torus, pod, ring; plus the fat-tree and
                  hex-array machine models of ``repro_torch.core``)
  interceptor  -- a counting wrapper over the ``repro_torch.dist._collectives``
                  seam capturing the collectives every rank of the per-rank
                  programs calls
  conformance  -- ``check(plan)``: trace == interceptor == analytic cost
                  model, plus the equivariance/bijection/translation
                  predicates and the Irony--Toledo--Tiskin bound;
                  ``run_matrix`` sweeps strategy x mesh x case x dtype;
                  ``check_capture`` holds a live run (served tokens, a
                  planned forward) to the traces of the plans it executed

  drift        -- ``check_drift``: obs == interceptor == trace on live
                  runs of every lowering family, plus ranking drift (a
                  stored machine profile against a fresh calibration) and
                  tuning drift (a stored table's winners re-timed)
"""
from . import conformance, drift, interceptor, trace
from .conformance import (ConformanceError, ConformanceReport, check,
                          check_capture, compare_records, hlo_collective_bytes,
                          matrix_cells, predicted_words_per_device,
                          run_matrix)
from .drift import (DRIFT_CELLS, RANKING_SHAPES, check_drift, measure_cell,
                    ranking_drift, tuning_drift)
from .interceptor import Capture, intercept, measure_plan
from .trace import (CollectiveRecord, MachineTrace, Trace, canonical_perm,
                    fattree_a_level_words, fattree_level_words, padded_dims,
                    trace_fattree, trace_hex, trace_plan, tree_level_words)

__all__ = [
    "conformance", "drift", "interceptor", "trace",
    "DRIFT_CELLS", "RANKING_SHAPES", "check_drift", "measure_cell", "ranking_drift",
    "tuning_drift",
    "ConformanceError", "ConformanceReport", "check", "check_capture", "compare_records",
    "hlo_collective_bytes", "matrix_cells", "predicted_words_per_device",
    "run_matrix", "Capture", "intercept", "measure_plan",
    "CollectiveRecord", "MachineTrace", "Trace", "canonical_perm",
    "fattree_a_level_words", "fattree_level_words", "padded_dims",
    "trace_fattree", "trace_hex", "trace_plan", "tree_level_words",
]
