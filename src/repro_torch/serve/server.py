"""Serving server: bucket routing, warmup, latency accounting.

Counterpart of ``repro.serve.server``.  ``warmup()`` runs each declared
(batch, seq) bucket once -- a prefill and two decode steps -- so the kernel
library is built, the kernels' tile tables are on the device, each
bucket's KV cache is allocated and, with a ``mesh``, each bucket's plans
are in the plan cache before the first request.  With ``mesh=`` (a
``repro_torch.dist.Mesh``, or its sizes such as ``(2, 2)``, built on the
parameters' device) every projection of warmup and serving runs through
the plan engine (``planned_scope``): planned, and executed as per-rank
programs whose block products are K1; ``strategy=`` pins one schedule.
``generate()`` routes a request batch to the smallest bucket that fits
(left-padding prompts with per-row position offsets, padding the batch
with dummy rows) and measures TTFT and per-token latency around
synchronised device work.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import maybe_sync, param_device
from repro_torch.dist.mesh import Mesh, parse_mesh
from repro_torch.kernels.matmul import kernel as zorder_kernel
from repro_torch.plan import cache_info
from repro_torch.plan.lower_dist import executions_snapshot
from repro_torch.runtime.serve import ServeConfig, batch_requests, decode_loop, planned_scope

from .buckets import Bucket, as_bucket, route

DEFAULT_BUCKETS = ((4, 16), (4, 32), (8, 16), (8, 32))
PAD_ID = 0        # left-padding token (masked out through the offsets)
DUMMY_TOKEN = 1   # fills the dummy rows that pad a batch to its bucket


@dataclasses.dataclass
class ServeResult:
    """One served batch: per-request token sequences + latency breakdown."""

    sequences: List[List[int]]        # prompt + generated, padding stripped
    new_tokens: List[List[int]]       # generated suffix per request
    bucket: Optional[str]             # routed bucket label, None = cold
    ttft_s: float                     # prefill + first sampled token
    step_latencies_s: np.ndarray      # per-token decode latency (after 1st)
    wall_s: float

    @property
    def generated_tokens(self) -> int:
        return sum(len(t) for t in self.new_tokens)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s > 0 else 0.0

    def latency_quantiles_ms(self) -> Dict[str, Optional[float]]:
        """p50/p99 per-token decode latency in ms; None without a timed
        step (max_new_tokens <= 1)."""
        if self.step_latencies_s.size == 0:
            return {"p50_ms": None, "p99_ms": None}
        return {
            "p50_ms": float(np.percentile(self.step_latencies_s, 50) * 1e3),
            "p99_ms": float(np.percentile(self.step_latencies_s, 99) * 1e3),
        }


def _as_mesh(mesh, device) -> Optional[Mesh]:
    """``mesh`` as a ``Mesh``: None, a ``Mesh``, or its sizes (a tuple of
    ints or an ``"RxC"`` string) for a mesh on ``device``."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, str):
        return parse_mesh(mesh, device=device)
    try:
        sizes = tuple(int(s) for s in mesh)
    except (TypeError, ValueError):
        raise ValueError(f"mesh must be a repro_torch Mesh or its sizes, got {mesh!r}") from None
    return Mesh(sizes, device=device)


def _moved(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


class Server:
    """Serving harness over one model (see module doc).  The model must
    take per-row position offsets (``DecoderLM`` does), so prompts can be
    left-padded into a bucket."""

    def __init__(self, model, params, cfg: ServeConfig, *, mesh=None,
                 strategy: Optional[str] = None,
                 buckets: Sequence = DEFAULT_BUCKETS):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = param_device(params)
        self.mesh = _as_mesh(mesh, self.device)
        if strategy is not None and self.mesh is None:
            raise ValueError(f"strategy={strategy!r} needs a mesh")
        self.strategy = strategy
        self._plans: Dict[str, int] = collections.Counter()
        self._warm_plans: Dict[str, int] = {}
        self.buckets: Tuple[Bucket, ...] = tuple(
            sorted(as_bucket(b) for b in buckets))
        for b in self.buckets:
            cfg.validate_prompt_len(b.seq)
        self._caches: Dict[Bucket, Dict] = {}
        self._warm_launches: Optional[int] = None

    # -- warmup --------------------------------------------------------------

    def warmup(self) -> Dict:
        """Run a dummy prefill + two decode steps per bucket.  Returns
        ``{label: {"warm_s": seconds}}``."""
        report: Dict[str, Dict] = {}
        before = executions_snapshot()
        with torch.no_grad(), planned_scope(self.mesh, self.strategy):
            for bucket in self.buckets:
                t0 = time.perf_counter()
                cache = self._cache(bucket)
                toks = torch.full((bucket.batch, bucket.seq), DUMMY_TOKEN,
                                  dtype=torch.int64, device=self.device)
                offsets = torch.zeros(bucket.batch, dtype=torch.int64, device=self.device)
                steps = min(3, self.cfg.max_new_tokens)
                decode_loop(self.model, self.params, cache, toks, offsets,
                            dataclasses.replace(self.cfg, max_new_tokens=steps), None)
                maybe_sync(self.device)
                report[bucket.label] = {"warm_s": time.perf_counter() - t0}
        self._warm_launches = zorder_kernel.launches
        self._warm_plans = _moved(before, executions_snapshot())
        return report

    def _cache(self, bucket: Bucket) -> Dict:
        """The bucket's preallocated KV cache, zeroed for a new batch."""
        cache = self._caches.get(bucket)
        if cache is None:
            cache = self.model.init_cache(bucket.batch, self.cfg.max_seq, self.device)
            self._caches[bucket] = cache
        else:
            for layer in cache["layers"]:
                for t in layer.values():
                    t.zero_()
        return cache

    # -- serving -------------------------------------------------------------

    def generate(self, prompt_list: Sequence[Sequence[int]],
                 generator: Optional[torch.Generator] = None) -> ServeResult:
        """Serve one request batch: route, pad, decode, strip padding."""
        if not prompt_list:
            return ServeResult([], [], None, 0.0, np.zeros(0), 0.0)
        t_start = time.perf_counter()
        n = len(prompt_list)
        maxlen = max(len(p) for p in prompt_list)
        bucket = route(n, maxlen, self.buckets)
        if bucket is None:
            batch, lens = batch_requests(prompt_list, PAD_ID)
            cache = self.model.init_cache(n, self.cfg.max_seq, self.device)
        else:
            dummies = [[DUMMY_TOKEN]] * (bucket.batch - n)
            batch, lens = batch_requests(
                list(prompt_list) + dummies, PAD_ID, pad_to=bucket.seq)
            cache = self._cache(bucket)
        self.cfg.validate_prompt_len(batch.shape[1])

        sp = batch.shape[1]
        tokens = torch.as_tensor(batch, dtype=torch.int64, device=self.device)
        offsets = torch.as_tensor(sp - lens, dtype=torch.int64, device=self.device)

        def mark():
            maybe_sync(self.device)
            return time.perf_counter()

        before = executions_snapshot()
        with torch.no_grad(), planned_scope(self.mesh, self.strategy):
            full, marks = decode_loop(self.model, self.params, cache, tokens,
                                      offsets, self.cfg, generator, on_token=mark)
        self._plans.update(_moved(before, executions_snapshot()))
        wall = time.perf_counter() - t_start
        ttft = (marks[0] if marks else time.perf_counter()) - t_start

        sequences, new_tokens = [], []
        for i in range(n):
            seq = full[i, sp - int(lens[i]):].tolist()   # strip left padding
            sequences.append(seq)
            new_tokens.append(seq[int(lens[i]):])
        return ServeResult(sequences, new_tokens,
                           bucket.label if bucket else None,
                           ttft, np.diff(np.asarray(marks)), wall)

    def plan_report(self) -> Dict:
        """Plan-engine accounting: the mesh, the products served per
        strategy (``"strategy"`` or ``"strategy+ov"`` for the overlapped
        lowering) by ``generate`` and by ``warmup``, and the plan cache's
        hits and misses.  Empty strategy counts without a mesh."""
        return {"mesh": None if self.mesh is None else dict(self.mesh.shape),
                "strategy": self.strategy,
                "strategies": dict(sorted(self._plans.items())),
                "warmup_strategies": dict(self._warm_plans),
                "cache": cache_info()}

    def cache_report(self) -> Dict:
        """Kernel accounting: the Z-order matmul's launches in total and
        since warmup."""
        total = zorder_kernel.launches
        since = None if self._warm_launches is None else total - self._warm_launches
        return {"kernels": {"zorder_matmul": {"launches": total,
                                              "since_warmup": since}}}


def warmup(model, params, cfg: ServeConfig, *, mesh=None, strategy: Optional[str] = None,
           buckets: Sequence = DEFAULT_BUCKETS) -> Server:
    """Build a ``Server`` and warm its buckets in one call; the per-bucket
    report is kept as ``server.warmup_report``."""
    server = Server(model, params, cfg, mesh=mesh, strategy=strategy, buckets=buckets)
    server.warmup_report = server.warmup()
    return server
