"""Serving server: bucket routing, warmup, steps captured once per bucket,
latency accounting.

Counterpart of ``repro.serve.server``, which compiles one prefill and one
decode program per bucket at warmup and replays them.  Here:

  * ``warmup()`` runs each declared (batch, seq) bucket eagerly once -- a
    prefill and up to three decode steps -- so the kernel library is
    built, the kernels' tile tables are on the device, each bucket's KV
    cache is allocated and, with a ``mesh``, each bucket's plans are in
    the plan cache and a live ``tuning=`` tuner has searched each
    bucket's per-rank kernel shapes.  Then, on CUDA, it captures the
    bucket's prefill and its decode step as ``torch.cuda.CUDAGraph``s,
    planned or not: static token, offset, current-token and slot (``pos``)
    buffers, the bucket's preallocated cache, one graph memory pool for
    all buckets.  A planned step's rank threads launch on the capturing
    stream.  A failed capture raises; nothing falls back to eager.
  * ``generate()`` routes a request batch to the smallest bucket that
    fits (left-padding prompts with per-row position offsets, padding the
    batch with dummy rows), copies it into the bucket's static buffers and
    replays the graphs, sampling between replays on the device.  Tokens
    equal the eager path's bitwise: ``runtime.serve.generate`` on the same
    bucket-padded batch (``batch_requests(prompts + dummies,
    pad_to=bucket.seq)``).  A CPU model is served eagerly; so is a request
    no bucket fits (cold), which is counted.  TTFT and per-token latency
    are measured around synchronised device work.

Replays launch nothing from Python, so the kernel launch counters, the
plan engine's execution counts and the interceptor see nothing of them:
``cache_report()`` and ``plan_report()`` count replays x each graph's
launches and products, recorded at capture.  A bucket's graphs replay on
one stream, one at a time (K1's thin route shares its split-K arrival
counters per device).

With ``mesh=`` (a ``repro_torch.dist.Mesh``, or its sizes such as
``(2, 2)``, built on the parameters' device) every projection runs
through the plan engine (``planned_scope``); ``strategy=`` pins one
schedule, ``tuning=`` (a ``repro_torch.tune`` table or live ``Tuner``)
prices and tiles the plans with measured kernel seconds.  Observability,
all guarded on ``obs.enabled()``: ``serve.warmup`` / ``serve.prefill`` /
``serve.decode_step`` spans, ``serve.ttft_us`` / ``serve.decode_token_us``
histograms, ``serve.warmup.buckets`` / ``serve.requests`` /
``serve.tokens`` / ``serve.cold_bucket`` / ``serve.plan_repin`` counters.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import maybe_sync, param_device
from repro_torch.dist.mesh import Mesh, parse_mesh
from repro_torch.kernels.matmul import kernel as zorder_kernel
from repro_torch.plan import cache_info, plan_cache
from repro_torch.plan.lower_dist import executions_snapshot
from repro_torch.runtime.serve import (ServeConfig, batch_requests, decode_loop, planned_scope,
                                       token_loop)

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
    plan_probe: Dict[str, int] = dataclasses.field(default_factory=dict)
    graphs: bool = False              # served by replaying captured steps

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


@dataclasses.dataclass
class _Step:
    """One captured step: the graph, its static output, what the capture
    launched (K1 launches by route, planned products by strategy) and how
    often it was replayed."""

    graph: "torch.cuda.CUDAGraph"
    logits: torch.Tensor
    k1_routes: Dict[str, int]
    products: Dict[str, int]
    replays: int = 0


@dataclasses.dataclass
class _BucketGraphs:
    """A bucket's static input buffers and its captured steps."""

    tokens: torch.Tensor      # (B, S) int64, the padded prompt batch
    offsets: torch.Tensor     # (B,) int64, per-row left padding
    cur: torch.Tensor         # (B, 1) int64, the decode step's input token
    pos: torch.Tensor         # () int64, the decode step's cache slot
    cache: Dict
    steps: Dict[str, _Step] = dataclasses.field(default_factory=dict)


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
                 strategy: Optional[str] = None, tuning=None,
                 buckets: Sequence = DEFAULT_BUCKETS):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = param_device(params)
        self.mesh = _as_mesh(mesh, self.device)
        if strategy is not None and self.mesh is None:
            raise ValueError(f"strategy={strategy!r} needs a mesh")
        self.strategy = strategy
        self.tuning = tuning
        self.graphs = self.device.type == "cuda"     # buckets captured at warmup
        self._plans: Dict[str, int] = collections.Counter()
        self._warm_plans: Dict[str, int] = {}
        self.buckets: Tuple[Bucket, ...] = tuple(
            sorted(as_bucket(b) for b in buckets))
        for b in self.buckets:
            cfg.validate_prompt_len(b.seq)
        self._caches: Dict[Bucket, Dict] = {}
        self._captured: Dict[Bucket, _BucketGraphs] = {}
        self._pool = None                 # one graph memory pool for every bucket
        self._bucket_plans: Dict[Bucket, Dict] = {}
        self._bucket_tune_keys: Dict[Bucket, Tuple] = {}
        self._warm_launches: Optional[int] = None
        self._warm_cache_info: Optional[Dict[str, int]] = None
        self._warm_tune_stats: Optional[Dict[str, int]] = None

    def _scope(self):
        return planned_scope(self.mesh, self.strategy, self.tuning)

    # -- warmup --------------------------------------------------------------

    def warmup(self) -> Dict:
        """Run a dummy prefill + up to three decode steps per bucket, then
        (on CUDA) capture the bucket's prefill and decode step.
        Returns ``{label: {"warm_s", "plans", "capture_s", "graphs"}}``."""
        report: Dict[str, Dict] = {}
        before = executions_snapshot()
        with torch.no_grad(), self._scope():
            for bucket in self.buckets:
                t0 = time.perf_counter()
                keys_before = set(plan_cache.keys())
                tune_before = set(self._tune_keys())
                with obs.span("serve.warmup", bucket=bucket.label):
                    cache = self._cache(bucket)
                    toks = torch.full((bucket.batch, bucket.seq), DUMMY_TOKEN,
                                      dtype=torch.int64, device=self.device)
                    offsets = torch.zeros(bucket.batch, dtype=torch.int64, device=self.device)
                    steps = min(3, self.cfg.max_new_tokens)
                    decode_loop(self.model, self.params, cache, toks, offsets,
                                dataclasses.replace(self.cfg, max_new_tokens=steps), None)
                    maybe_sync(self.device)
                rec = {"warm_s": time.perf_counter() - t0}
                new_keys = [k for k in plan_cache.keys() if k not in keys_before]
                # buckets can share plans (one decode batch): extend, don't replace
                self._bucket_plans.setdefault(bucket, {}).update(
                    {k: plan_cache.get(k) for k in new_keys})
                rec["plans"] = len(new_keys)
                prev = self._bucket_tune_keys.get(bucket, ())
                self._bucket_tune_keys[bucket] = prev + tuple(
                    k for k in self._tune_keys() if k not in tune_before and k not in prev)
                if self.graphs:
                    t1 = time.perf_counter()
                    self._capture(bucket)
                    rec["capture_s"] = time.perf_counter() - t1
                    rec["graphs"] = len(self._captured[bucket].steps)
                report[bucket.label] = rec
        if obs.enabled():
            obs.counter("serve.warmup.buckets").inc(len(self.buckets))
        self._warm_launches = zorder_kernel.launches
        self._warm_plans = _moved(before, executions_snapshot())
        self._warm_cache_info = cache_info()
        if self.tuning is not None and hasattr(self.tuning, "stats"):
            self._warm_tune_stats = dict(self.tuning.stats)
        return report

    def _tune_keys(self) -> Tuple:
        return tuple(self.tuning.keys()) if hasattr(self.tuning, "keys") else ()

    def _cache(self, bucket: Bucket) -> Dict:
        """The bucket's preallocated KV cache, zeroed for a new batch."""
        cache = self._caches.get(bucket)
        if cache is None:
            cache = self.model.init_cache(bucket.batch, self.cfg.max_seq, self.device)
            self._caches[bucket] = cache
        else:
            _zero(cache)
        return cache

    def _capture(self, bucket: Bucket) -> None:
        """Capture the bucket's prefill (cache zeroing included, as eager
        ``_cache`` zeroes it) and decode step over static buffers."""
        dev = self.device
        cache = self._cache(bucket)
        g = _BucketGraphs(
            tokens=torch.full((bucket.batch, bucket.seq), DUMMY_TOKEN, dtype=torch.int64,
                              device=dev),
            offsets=torch.zeros(bucket.batch, dtype=torch.int64, device=dev),
            cur=torch.full((bucket.batch, 1), DUMMY_TOKEN, dtype=torch.int64, device=dev),
            pos=torch.full((), bucket.seq, dtype=torch.int64, device=dev),
            cache=cache)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()

        def prefill():
            _zero(cache)
            return self.model.prefill(self.params, cache, g.tokens, g.offsets)[0]

        def decode():
            return self.model.decode_step(self.params, cache, g.cur, g.pos, g.offsets)[0]

        g.steps["prefill"] = self._capture_step(prefill)
        if self.cfg.max_new_tokens > 1:
            g.steps["decode"] = self._capture_step(decode)
        self._captured[bucket] = g

    def _capture_step(self, fn) -> _Step:
        routes = dict(zorder_kernel.launches_by_route)
        plans = executions_snapshot()
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            logits = fn()
        return _Step(graph, logits, _moved(routes, zorder_kernel.launches_by_route),
                     _moved(plans, executions_snapshot()))

    # -- serving -------------------------------------------------------------

    def generate(self, prompt_list: Sequence[Sequence[int]],
                 generator: Optional[torch.Generator] = None) -> ServeResult:
        """Serve one request batch: route, pad, decode (replaying the
        bucket's captured steps where there are some), strip padding."""
        if not prompt_list:
            return ServeResult([], [], None, 0.0, np.zeros(0), 0.0)
        t_start = time.perf_counter()
        n = len(prompt_list)
        maxlen = max(len(p) for p in prompt_list)
        bucket = route(n, maxlen, self.buckets)
        probe = self._probe_bucket(bucket)
        if bucket is None:
            if obs.enabled():
                obs.counter("serve.cold_bucket").inc()
            batch, lens = batch_requests(prompt_list, PAD_ID)
        else:
            dummies = [[DUMMY_TOKEN]] * (bucket.batch - n)
            batch, lens = batch_requests(
                list(prompt_list) + dummies, PAD_ID, pad_to=bucket.seq)
        self.cfg.validate_prompt_len(batch.shape[1])
        sp = batch.shape[1]

        def mark():
            maybe_sync(self.device)
            return time.perf_counter()

        captured = self._captured.get(bucket)
        with torch.no_grad():
            if captured is not None:
                full, marks = self._replay(captured, batch, lens, generator, mark)
            else:
                tokens = torch.as_tensor(batch, dtype=torch.int64, device=self.device)
                offsets = torch.as_tensor(sp - lens, dtype=torch.int64, device=self.device)
                cache = (self._cache(bucket) if bucket is not None else
                         self.model.init_cache(n, self.cfg.max_seq, self.device))
                before = executions_snapshot()
                with self._scope():
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
        steps = np.diff(np.asarray(marks))
        if obs.enabled():
            obs.counter("serve.requests").inc(n, bucket=bucket.label if bucket else "cold")
            obs.counter("serve.tokens").inc(sum(len(t) for t in new_tokens))
            obs.histogram("serve.ttft_us").observe(ttft * 1e6)
            h = obs.histogram("serve.decode_token_us")
            for dt in steps:
                h.observe(dt * 1e6)
        return ServeResult(sequences, new_tokens, bucket.label if bucket else None,
                           ttft, steps, wall, probe, captured is not None)

    def _replay(self, g: _BucketGraphs, batch: np.ndarray, lens: np.ndarray,
                generator, mark) -> Tuple[np.ndarray, list]:
        """``token_loop`` through the captured steps: the request copied
        into the static buffers, each step's inputs copied in and its
        graph replayed."""
        sp = batch.shape[1]
        g.tokens.copy_(torch.from_numpy(batch))
        g.offsets.copy_(torch.from_numpy((sp - lens).astype(np.int64)))

        def decode(cur, pos):
            g.cur.copy_(cur)
            g.pos.copy_(pos)
            return self._replay_step(g.steps["decode"])

        return token_loop(self.model, g.cache, g.tokens, self.cfg, generator,
                          prefill=lambda: self._replay_step(g.steps["prefill"]),
                          step=decode, on_token=mark)

    def _replay_step(self, step: _Step) -> torch.Tensor:
        step.graph.replay()
        step.replays += 1
        for s, v in step.products.items():
            self._plans[s] += v
        return step.logits

    # -- accounting ----------------------------------------------------------

    def _probe_bucket(self, bucket: Optional[Bucket]) -> Dict[str, int]:
        """Re-``get`` the bucket's warm plan keys: all hits after warmup;
        an evicted entry is re-pinned from the warmup snapshot and
        counted (``serve.plan_repin``).  With a tuner, also probe the
        bucket's tuning keys."""
        if bucket is None or bucket not in self._bucket_plans:
            return {"probed": 0, "missing": 0}
        snapshot = self._bucket_plans[bucket]
        missing = [k for k in snapshot if plan_cache.get(k) is None]
        for k in missing:
            if snapshot[k] is not None:
                plan_cache.put(k, snapshot[k])
        if missing and obs.enabled():
            obs.counter("serve.plan_repin").inc(len(missing))
        out = {"probed": len(snapshot), "missing": len(missing)}
        if self.tuning is not None and hasattr(self.tuning, "lookup_key"):
            tune_keys = self._bucket_tune_keys.get(bucket, ())
            out["tune_probed"] = len(tune_keys)
            out["tune_missing"] = sum(self.tuning.lookup_key(k) is None for k in tune_keys)
        return out

    def plan_report(self) -> Dict:
        """Plan-engine accounting: the mesh, the products served per
        strategy (``"strategy"`` or ``"strategy+ov"`` for the overlapped
        lowering) by ``generate`` -- eager runs counted as they execute,
        graph replays as replays x the products each graph's capture ran
        -- and by ``warmup`` (its eager pass and its captures), and the
        plan cache's hits and misses, in total and since warmup.  Empty
        strategy counts without a mesh."""
        info = cache_info()
        rep = {"mesh": None if self.mesh is None else dict(self.mesh.shape),
               "strategy": self.strategy,
               "strategies": dict(sorted(self._plans.items())),
               "warmup_strategies": dict(self._warm_plans),
               "cache": info}
        if self._warm_cache_info is not None:
            hits = info["hits"] - self._warm_cache_info["hits"]
            misses = info["misses"] - self._warm_cache_info["misses"]
            rep["serve_window"] = {"hits": hits, "misses": misses,
                                   "hit_rate": hits / (hits + misses) if hits + misses else None}
        return rep

    def cache_report(self) -> Dict:
        """Kernel accounting: the Z-order matmul's counted launches in total
        and since warmup (eager launches and captures: a replay launches
        nothing from Python), the launches graph replays ran (replays x
        each graph's launches by route, recorded at capture), each
        bucket's graphs; and, with a tuner, its entries and the serve
        window's tuning hit rate."""
        total = zorder_kernel.launches
        since = None if self._warm_launches is None else total - self._warm_launches
        replayed: Dict[str, int] = collections.Counter()
        graphs = {}
        for bucket, g in self._captured.items():
            graphs[bucket.label] = {}
            for name, step in g.steps.items():
                for r, v in step.k1_routes.items():
                    replayed[r] += step.replays * v
                graphs[bucket.label][name] = {"replays": step.replays,
                                              "k1_per_replay": dict(step.k1_routes),
                                              "products_per_replay": dict(step.products)}
        rep: Dict = {"kernels": {"zorder_matmul": {
            "launches": total, "since_warmup": since,
            "replayed": sum(replayed.values()),
            "replayed_by_route": {r: v for r, v in replayed.items() if v}}},
            "graphs": graphs}
        if self.tuning is not None and hasattr(self.tuning, "stats"):
            stats = dict(self.tuning.stats)
            tun: Dict = {"entries": len(self._tune_keys()), "stats": stats}
            if self._warm_tune_stats is not None:
                hits = stats["hits"] - self._warm_tune_stats["hits"]
                misses = stats["misses"] - self._warm_tune_stats["misses"]
                tun["serve_window"] = {"hits": hits, "misses": misses,
                                       "hit_rate": hits / (hits + misses) if hits + misses
                                       else None}
            rep["tuning"] = tun
        return rep


def _zero(cache: Dict) -> None:
    for layer in cache["layers"]:
        for t in layer.values():
            t.zero_()


def warmup(model, params, cfg: ServeConfig, *, mesh=None, strategy: Optional[str] = None,
           tuning=None, buckets: Sequence = DEFAULT_BUCKETS) -> Server:
    """Build a ``Server`` and warm its buckets in one call; the per-bucket
    report is kept as ``server.warmup_report``."""
    server = Server(model, params, cfg, mesh=mesh, strategy=strategy, tuning=tuning,
                    buckets=buckets)
    server.warmup_report = server.warmup()
    return server
