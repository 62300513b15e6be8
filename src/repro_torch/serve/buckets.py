"""(batch, seq) bucket grid + router for the serving harness (a copy of
``repro.serve.buckets``).

Warmup runs each declared bucket once; the router snaps every request
batch to the smallest bucket that fits -- requests are left-padded to
``bucket.seq`` and the batch is padded with dummy rows to ``bucket.batch``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One warm serving shape: ``batch`` requests x ``seq`` prompt slots."""

    batch: int
    seq: int

    def __post_init__(self):
        if self.batch < 1 or self.seq < 1:
            raise ValueError(f"bucket sides must be >= 1, got {self}")

    @property
    def label(self) -> str:
        return f"{self.batch}x{self.seq}"


def as_bucket(b) -> Bucket:
    if isinstance(b, Bucket):
        return b
    batch, seq = b
    return Bucket(int(batch), int(seq))


def bucket_grid(batches: Iterable[int], seqs: Iterable[int]) -> Tuple[Bucket, ...]:
    """The full batches x seqs grid, sorted ascending (batch, then seq)."""
    return tuple(sorted(Bucket(int(b), int(s))
                        for b in set(batches) for s in set(seqs)))


def route(n_requests: int, max_prompt_len: int,
          buckets: Sequence[Bucket]) -> Optional[Bucket]:
    """The cheapest bucket fitting ``n_requests`` prompts of length
    <= ``max_prompt_len``: smallest padded token area (batch * seq), ties
    to the smaller batch.  None when nothing fits (served cold)."""
    fitting = [b for b in buckets
               if b.batch >= n_requests and b.seq >= max_prompt_len]
    if not fitting:
        return None
    return min(fitting, key=lambda b: (b.batch * b.seq, b.batch, b.seq))
