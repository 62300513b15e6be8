"""repro_torch.tune -- measured K1 autotuning for the planner.

Port of ``repro.tune``.  The calibrated cost model (``repro_torch.obs``)
measures the *communication* side of ``calibrated_total_s``; this package
measures the *compute* side.  A search over the Z-order matmul's (K1's)
compiled (block_m, block_n, block_k) shapes x tile orders -- the ones
``ops.matmul`` accepts at the shape, each checked against the plain
version and timed on the card -- lands winners (the default blocks unless
a candidate beats them by more than the timing noise) in
a versioned :class:`TuningTable` keyed by device kind x dtype x shape
bucket.  ``build_plan(tuning=...)`` (or a ``MachineProfile`` with an
embedded table) then ranks strategies and resolves overlap with measured
kernel seconds against calibrated comm seconds, and folds the winning
blocks into the plan's ``TilingPlan`` for each rank's block products.
"""
from .search import (ORDERS, Tuner, candidate_route, candidate_space,
                     default_candidate, time_candidate, tune_shape, tune_shapes)
from .table import (TUNING_SCHEMA, TunedBlocks, TuningTable, load_table,
                    padded_flops, save_table, scaled_call_seconds,
                    shape_bucket, table_key)

__all__ = [
    "TUNING_SCHEMA", "TunedBlocks", "TuningTable",
    "load_table", "save_table", "shape_bucket", "table_key",
    "padded_flops", "scaled_call_seconds",
    "Tuner", "candidate_space", "candidate_route", "default_candidate", "time_candidate",
    "tune_shape", "tune_shapes", "ORDERS",
]
