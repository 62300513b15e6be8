"""Plan cache: memoizes ``build_plan`` so repeated layer calls skip the
cost-model ranking and schedule/permutation construction.

Port of ``repro.plan.cache`` (its tracing counters wait for the port's
observability slice).

Keys are ``(batch, shapes, dtypes, mesh fingerprint, strategy override,
axes, schedule, tiling, profile)`` -- everything that changes the emitted
program or its ranking.  Stats are exposed for tests and the benchmark
smoke job (a dispatch regression shows up as a miss storm):
``cache_info()`` is the public functools-style view (hits, misses, size,
evictions, max entries), surfaced by ``Server.plan_report``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional



class PlanCache:
    """A small thread-safe memo table with hit/miss/eviction counters."""

    def __init__(self, max_entries: int = 1024):
        self._store: Dict[Any, Any] = {}
        self._lock = threading.Lock()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key) -> Optional[Any]:
        with self._lock:
            plan = self._store.get(key)
            if plan is None:
                self.misses += 1
            else:
                self.hits += 1
        return plan

    def put(self, key, plan) -> None:
        with self._lock:
            if key not in self._store and \
                    len(self._store) >= self.max_entries:
                # drop the oldest insertion (dict preserves order)
                self._store.pop(next(iter(self._store)))
                self.evictions += 1
            self._store[key] = plan

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0

    def keys(self) -> tuple:
        """Snapshot of the resident plan keys (insertion order)."""
        with self._lock:
            return tuple(self._store)

    def plans(self) -> tuple:
        """Snapshot of the resident plans (insertion order)."""
        with self._lock:
            return tuple(self._store.values())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "size": len(self._store)}

    def info(self) -> Dict[str, int]:
        """functools.lru_cache-style accounting, plus evictions."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "currsize": len(self._store),
                    "maxsize": self.max_entries,
                    "evictions": self.evictions}


plan_cache = PlanCache()


def cache_stats() -> Dict[str, int]:
    return plan_cache.stats()


def cache_info() -> Dict[str, int]:
    """Public hit/miss/size/eviction accounting of the process-global plan
    cache (see ``PlanCache.info``)."""
    return plan_cache.info()


def cache_clear() -> None:
    plan_cache.clear()
