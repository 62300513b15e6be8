"""Versioned kernel-tuning tables: measured K1 winners on disk.

Port of ``repro.tune.table``.  A :class:`TuningTable` is what an autotune
run (``repro_torch.tune.search`` / ``python -m
repro_torch.launch.perf_probe --tune``) persists: for each dtype x
shape bucket of one device kind (``torch.cuda.get_device_name()``), the
winning (block_m, block_n, block_k, order) candidate of the Z-order matmul
(K1) and its measured seconds at the bucket shape.  The planner consumes
entries two ways:

  * ``compute_seconds(m, n, k, dtype)`` -- the measured kernel time scaled
    to the call's FLOPs.  ``build_plan(tuning=...)`` substitutes it for the
    peak-FLOPs compute term of ``core.cost.calibrated_total_s``, so
    strategy ranking and the overlap decision compare *measured* compute
    against calibrated communication.
  * ``entry_for(m, n, k, dtype)`` -- the winning blocks themselves, which
    ``build_plan`` folds into the plan's ``TilingPlan`` so each rank's
    block products run them.

Shapes are bucketed (:func:`shape_bucket`) so nearby shapes share one
entry.  The reference pads every dim to the TPU's 128-wide MXU tile; on
the card that would put a 4-row decode product (K1's thin route, 16-row
tiles), a 64-row one (thin, 64-row tiles) and a 128-row one (wide route)
into one bucket.  Here rows keep K1's route thresholds apart (``SMALL_M``,
``THIN_MAX_M``, then powers of two), and a column or contraction dim that
16-byte copies cannot take (not a multiple of 8) stays exact, so the
bucket's timing shape takes the route the call takes.  The JSON schema is
the reference's: a table written by one package loads in the other.
Tables are frozen/hashable (they participate in the plan-cache key) with
lookup hit/miss counters in a non-compared ``stats`` field.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

from repro_torch.kernels.matmul.kernel import SMALL_M, THIN_MAX_M

TUNING_SCHEMA = 1

Key = Tuple[str, int, int, int]  # (dtype name, bucket m, bucket n, bucket k)


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def shape_bucket(m: int, n: int, k: int) -> Tuple[int, int, int]:
    """The shape bucket of an (m, k) x (k, n) call: rows to ``SMALL_M``,
    ``THIN_MAX_M`` or the next power of two above (so 4 and 16 rows share
    a bucket, 17 and 64 share one, 65 and 128 another); a column or
    contraction dim that is a multiple of 8 to the next power of two (at
    least 8), any other kept exact."""

    def rows(x: int) -> int:
        if x <= SMALL_M:
            return SMALL_M
        if x <= THIN_MAX_M:
            return THIN_MAX_M
        return _pow2(x)

    def cols(x: int) -> int:
        return max(_pow2(x), 8) if x > 0 and x % 8 == 0 else int(x)

    return (rows(m), cols(n), cols(k))


def table_key(m: int, n: int, k: int, dtype: str) -> Key:
    """The lookup key of a call: dtype name x shape bucket (the device
    kind is the table's own identity, one table per device kind)."""
    return (str(dtype),) + shape_bucket(m, n, k)


def padded_flops(m: int, n: int, k: int) -> float:
    """FLOPs of one (m, k) x (k, n) call: 2 m n k.  K1 masks ragged edges
    instead of padding the operands (the reference pads each dim to the
    MXU tile; at multiples of 128 the two agree)."""
    return 2.0 * m * n * k


@dataclasses.dataclass(frozen=True)
class TunedBlocks:
    """One search winner: the blocks/order to run and the measured (best
    of ``reps``) seconds of one kernel call at ``bucket`` shape."""

    block_m: int
    block_n: int
    block_k: int
    order: str
    seconds: float
    bucket: Tuple[int, int, int]

    @property
    def bucket_flops(self) -> float:
        bm, bn, bk = self.bucket
        return 2.0 * bm * bn * bk

    @property
    def label(self) -> str:
        return f"{self.block_m}x{self.block_n}x{self.block_k}/{self.order}"


def scaled_call_seconds(entry: TunedBlocks, m: int, n: int, k: int) -> float:
    """``entry.seconds`` (measured at the bucket shape) scaled to one
    (m, k) x (k, n) call's FLOPs -- constant achieved FLOP rate within a
    bucket."""
    return entry.seconds * (padded_flops(m, n, k) / entry.bucket_flops)


def _new_stats() -> Dict[str, int]:
    return {"hits": 0, "misses": 0}


@dataclasses.dataclass(frozen=True)
class TuningTable:
    """Frozen winners for one device kind (see module docstring).

    ``stats`` counts lookups (hit/miss) without participating in eq/hash,
    so a table in a plan-cache key still accumulates the serve-window
    accounting ``repro_torch.serve.Server.cache_report`` exposes."""

    device_kind: str
    entries: Tuple[Tuple[Key, TunedBlocks], ...] = ()
    created: str = ""
    schema: int = TUNING_SCHEMA
    stats: Dict[str, int] = dataclasses.field(
        default_factory=_new_stats, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_idx", dict(self.entries))

    def keys(self) -> Tuple[Key, ...]:
        return tuple(k for k, _ in self.entries)

    def lookup_key(self, key: Key, count: bool = True) -> Optional[TunedBlocks]:
        entry = self._idx.get(key)
        if count:
            self.stats["hits" if entry is not None else "misses"] += 1
        return entry

    def lookup(self, m: int, n: int, k: int, dtype: str = "bfloat16",
               count: bool = True) -> Optional[TunedBlocks]:
        return self.lookup_key(table_key(m, n, k, dtype), count=count)

    def entry_for(self, m: int, n: int, k: int,
                  dtype: str = "bfloat16") -> Optional[TunedBlocks]:
        """Lookup-only twin of ``Tuner.entry_for`` (no search on miss), so
        frozen tables and live tuners are interchangeable in the planner."""
        return self.lookup(m, n, k, dtype)

    def compute_seconds(self, m: int, n: int, k: int,
                        dtype: str = "bfloat16") -> Optional[float]:
        """Measured seconds of one (m, k) x (k, n) kernel call, or None
        when the bucket has no entry (the planner then falls back to the
        peak-FLOPs roofline)."""
        entry = self.lookup(m, n, k, dtype)
        return None if entry is None else scaled_call_seconds(entry, m, n, k)

    def with_entry(self, m: int, n: int, k: int, dtype: str,
                   entry: TunedBlocks) -> "TuningTable":
        """Functional update (tests doctor tables with it): a new table
        with the bucket's entry replaced/added, stats reset."""
        key = table_key(m, n, k, dtype)
        kept = tuple((kk, e) for kk, e in self.entries if kk != key)
        return dataclasses.replace(
            self, entries=tuple(sorted(kept + ((key, entry),))),
            stats=_new_stats())

    def to_json(self) -> Dict:
        return {
            "schema": self.schema,
            "device_kind": self.device_kind,
            "created": self.created,
            "entries": [
                {"dtype": key[0], "bucket": list(key[1:]),
                 "block_m": e.block_m, "block_n": e.block_n,
                 "block_k": e.block_k, "order": e.order,
                 "seconds": e.seconds}
                for key, e in self.entries
            ],
        }

    @classmethod
    def from_json(cls, obj: Dict) -> "TuningTable":
        schema = int(obj.get("schema", 0))
        if schema > TUNING_SCHEMA:
            raise ValueError(
                f"tuning table schema {schema} is newer than supported "
                f"{TUNING_SCHEMA}; re-run the autotune search")
        entries = []
        for rec in obj.get("entries", []):
            bucket = tuple(int(x) for x in rec["bucket"])
            key = (str(rec["dtype"]),) + bucket
            entries.append((key, TunedBlocks(
                block_m=int(rec["block_m"]), block_n=int(rec["block_n"]),
                block_k=int(rec["block_k"]), order=str(rec["order"]),
                seconds=float(rec["seconds"]), bucket=bucket)))
        return cls(
            device_kind=obj.get("device_kind", "unknown"),
            entries=tuple(sorted(entries)),
            created=obj.get("created", ""),
            schema=schema or TUNING_SCHEMA,
        )


def save_table(table: TuningTable, path: str) -> str:
    with open(path, "w") as f:
        json.dump(table.to_json(), f, indent=1, sort_keys=True)
    return path


def load_table(path: str) -> TuningTable:
    with open(path) as f:
        return TuningTable.from_json(json.load(f))
