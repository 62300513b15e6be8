"""Serving server: bucket routing, warmup, steps captured once per bucket,
latency accounting.

Counterpart of ``repro.serve.server``, which compiles one prefill and one
decode program per bucket at warmup and replays them.  Here:

  * ``warmup(buckets=None)`` runs each given (batch, seq) bucket, or
    every declared one, eagerly once -- a prefill and up to three decode
    steps -- so the kernel library is built, the kernels' tile tables
    are on the device, each bucket's KV cache is allocated and, with a
    ``mesh``, each bucket's plans are in the plan cache and a live
    ``tuning=`` tuner has searched each bucket's per-rank kernel shapes.  Then, on CUDA, it captures the
    bucket's prefill and its decode step as ``torch.cuda.CUDAGraph``s,
    planned or not (a model without ``prefill`` has its teacher-forced
    prompt loop captured whole: S decode steps in one graph): static token,
    offset, current-token and slot (``pos``) buffers, the bucket's
    preallocated cache, one graph memory pool for all buckets.  A planned
    step's rank streams are the graph's branches: each ``Mesh.run`` forks
    them from the capturing stream and joins them back before the capture
    ends (the warm pass made them).  A failed capture raises; nothing
    falls back to eager.
  * ``generate()`` routes a request batch to the smallest bucket that
    fits (left-padding prompts with per-row position offsets, padding the
    batch with dummy rows), copies it into the bucket's static buffers and
    replays the graphs, sampling between replays on the device.  Tokens
    equal the eager path's bitwise: ``runtime.serve.generate`` on the same
    bucket-padded batch (``batch_requests(prompts + dummies, pad_id,
    pad_to=bucket.seq)``, the dummy rows ``[dummy_token]``).  A CPU model
    is served eagerly; so is a request no bucket fits (cold), which is
    counted, and one routed to a declared bucket that was not warmed: it
    is padded to that bucket and decoded eagerly in the bucket's cache,
    the same tokens a captured bucket gives (``ServeResult.graphs`` is
    False), where the reference compiles the bucket on first use.  TTFT
    and per-token latency are measured around synchronised device work.

Replays launch nothing from Python, so the kernel launch counters, the
plan engine's execution counts and the interceptor see nothing of them:
``cache_report()`` and ``plan_report()`` count replays x each graph's
launches and products, recorded at capture.  A bucket's graphs replay on
the caller's stream, one at a time: every graph that uses a rank stream's
split-K arrival counters (K1's thin route keeps one array per stream) is
ordered behind the one before.

With ``mesh=`` (a ``repro_torch.dist.Mesh``, or its sizes such as
``(2, 2)``, built on the parameters' device) every projection runs
through the plan engine (``planned_scope``); ``strategy=`` pins one
schedule, ``tuning=`` (a ``repro_torch.tune`` table or live ``Tuner``)
prices and tiles the plans with measured kernel seconds.

Observability, all guarded on ``obs.enabled()``:

  * spans: ``serve.warmup`` a bucket; ``serve.generate`` a call (tags
    ``bucket`` and ``batch``, a number of its own that every span inside
    carries); inside it ``serve.prefill``, ``serve.decode_step`` and
    ``serve.sample`` (``runtime.serve.token_loop``), ``serve.token_sync``
    (the latency clock's wait for the device), ``serve.inputs`` (copies
    into a bucket's static buffers) and ``serve.replay`` (the host's side
    of a graph replay);
  * counters: ``serve.warmup.buckets``, ``serve.requests{bucket}``,
    ``serve.tokens``, ``serve.cold_bucket``, ``serve.replays{step}``;
  * histograms: ``serve.ttft_us`` and ``serve.decode_token_us`` (host
    clock); on the card, ``serve.decode_step.device_us`` (a pair of CUDA
    events around each decode step's input copies and replay) and
    ``serve.between_steps.device_us`` (from one step's end event to the
    next one's start), and ``serve.graph.<span>_us``, each ``model.*`` /
    ``layer.*`` span's device time in one decode step (the sum over its
    calls), from the timing events a capture made with tracing on holds
    (``obs.graph_events``); ``serve.graph.prefill.<span>_us`` the same of
    the prefill graph.  All are read once a batch, after its last step,
    never between steps.  A bucket captured with tracing off holds no
    event: warm it again with tracing on to read the in-graph times.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
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
from repro_torch.runtime.serve import (ServeConfig, batch_requests, decode_loop, decode_step,
                                       planned_scope, token_loop)
from repro_torch.runtime.serve import prefill as run_prefill
from repro_torch.tree import tree_leaves

from .buckets import Bucket, as_bucket, route

DEFAULT_BUCKETS = ((4, 16), (4, 32), (8, 16), (8, 32))
# the reference's defaults of ``Server(pad_id=, dummy_token=)``
PAD_ID = 0        # left-padding token (masked out through the offsets)
DUMMY_TOKEN = 1   # fills the dummy rows that pad a batch to its bucket
_BATCH_IDS = itertools.count()   # the ``batch`` tag of each ``serve.generate``


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
    """One captured step: its name, the graph, its static output, what the
    capture launched (K1 launches by route, planned products by strategy),
    the timing events it holds (``obs.graph_events``, empty when captured
    with tracing off) and how often it was replayed."""

    name: str
    graph: "torch.cuda.CUDAGraph"
    logits: torch.Tensor
    k1_routes: Dict[str, int]
    products: Dict[str, int]
    events: List = dataclasses.field(default_factory=list)
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
    # a pair of timing events per decode step of a batch, made when a batch
    # is first served with tracing on
    step_events: Optional[List[Tuple["torch.cuda.Event", "torch.cuda.Event"]]] = None


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
    """Serving harness over one model (see module doc).  A model that takes
    per-row position offsets (``DecoderLM``) masks a left-padded prompt's
    padding; the others (hybrid, xLSTM, encoder-decoder) run it through
    their steps, as the reference's ``generate`` does, so a request decodes
    as the same bucket-padded row does, not as the prompt alone."""

    def __init__(self, model, params, cfg: ServeConfig, *, mesh=None,
                 strategy: Optional[str] = None, tuning=None,
                 buckets: Sequence = DEFAULT_BUCKETS,
                 pad_id: int = PAD_ID, dummy_token: int = DUMMY_TOKEN):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = param_device(params)
        self.mesh = _as_mesh(mesh, self.device)
        if strategy is not None and self.mesh is None:
            raise ValueError(f"strategy={strategy!r} needs a mesh")
        self.strategy = strategy
        self.tuning = tuning
        self.pad_id = pad_id
        self.dummy_token = dummy_token
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

    def warmup(self, buckets: Optional[Sequence] = None) -> Dict:
        """Run a dummy prefill + up to three decode steps for each of
        ``buckets`` (default: every declared bucket), then (on CUDA)
        capture the bucket's prefill and decode step; only warmed buckets
        are captured.  Returns ``{label: {"warm_s", "plans", "capture_s",
        "graphs"}}``."""
        buckets = self.buckets if buckets is None else tuple(as_bucket(b) for b in buckets)
        report: Dict[str, Dict] = {}
        before = executions_snapshot()
        with torch.no_grad(), self._scope():
            for bucket in buckets:
                t0 = time.perf_counter()
                keys_before = set(plan_cache.keys())
                tune_before = set(self._tune_keys())
                with obs.span("serve.warmup", bucket=bucket.label):
                    cache = self._cache(bucket)
                    toks = torch.full((bucket.batch, bucket.seq), self.dummy_token,
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
            obs.counter("serve.warmup.buckets").inc(len(buckets))
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
            tokens=torch.full((bucket.batch, bucket.seq), self.dummy_token, dtype=torch.int64,
                              device=dev),
            offsets=torch.zeros(bucket.batch, dtype=torch.int64, device=dev),
            cur=torch.full((bucket.batch, 1), self.dummy_token, dtype=torch.int64, device=dev),
            pos=torch.full((), bucket.seq, dtype=torch.int64, device=dev),
            cache=cache)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()

        def prefill():
            _zero(cache)
            return run_prefill(self.model, self.params, cache, g.tokens, g.offsets)

        def decode():
            return decode_step(self.model, self.params, cache, g.cur, g.pos, g.offsets)

        g.steps["prefill"] = self._capture_step("prefill", prefill)
        if self.cfg.max_new_tokens > 1:
            g.steps["decode"] = self._capture_step("decode", decode)
        self._captured[bucket] = g

    def _capture_step(self, name: str, fn) -> _Step:
        routes = dict(zorder_kernel.launches_by_route)
        plans = executions_snapshot()
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph, pool=self._pool)
        zorder_kernel.prepare_capture_stream(capture.capture_stream)
        torch.cuda.synchronize(self.device)
        with obs.graph_events() as events, capture:
            logits = fn()
        return _Step(name, graph, logits, _moved(routes, zorder_kernel.launches_by_route),
                     _moved(plans, executions_snapshot()), events)

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
        label = bucket.label if bucket else "cold"
        with obs.span("serve.generate", bucket=label, batch=next(_BATCH_IDS)):
            return self._generate(prompt_list, bucket, generator, t_start)

    def _generate(self, prompt_list, bucket: Optional[Bucket], generator,
                  t_start: float) -> ServeResult:
        """``generate`` past the routing, inside its ``serve.generate`` span."""
        n = len(prompt_list)
        probe = self._probe_bucket(bucket)
        if bucket is None:
            if obs.enabled():
                obs.counter("serve.cold_bucket").inc()
            batch, lens = batch_requests(prompt_list, self.pad_id)
        else:
            dummies = [[self.dummy_token]] * (bucket.batch - n)
            batch, lens = batch_requests(
                list(prompt_list) + dummies, self.pad_id, pad_to=bucket.seq)
        self.cfg.validate_prompt_len(batch.shape[1])
        sp = batch.shape[1]

        def mark():
            with obs.span("serve.token_sync"):
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
        with obs.span("serve.inputs"):
            g.tokens.copy_(torch.from_numpy(batch))
            g.offsets.copy_(torch.from_numpy((sp - lens).astype(np.int64)))
        if obs.enabled() and g.step_events is None:
            g.step_events = [(torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                             for _ in range(self.cfg.max_new_tokens - 1)]
        spare = iter(g.step_events if obs.enabled() else ())
        timed = []

        def decode(cur, pos):
            pair = next(spare, None)
            if pair is not None:
                timed.append(pair)
                pair[0].record()
            with obs.span("serve.inputs"):
                g.cur.copy_(cur)
                g.pos.copy_(pos)
            logits = self._replay_step(g.steps["decode"])
            if pair is not None:
                pair[1].record()
            return logits

        out = token_loop(self.model, g.cache, g.tokens, self.cfg, generator,
                         prefill=lambda: self._replay_step(g.steps["prefill"]),
                         step=decode, on_token=mark)
        if obs.enabled():
            _read_device_times(g, timed)
        return out

    def _replay_step(self, step: _Step) -> torch.Tensor:
        with obs.span("serve.replay", step=step.name):
            step.graph.replay()
        step.replays += 1
        if obs.enabled():
            obs.counter("serve.replays").inc(step=step.name)
        for s, v in step.products.items():
            self._plans[s] += v
        return step.logits

    # -- accounting ----------------------------------------------------------

    def _probe_bucket(self, bucket: Optional[Bucket]) -> Dict[str, int]:
        """Re-``get`` the bucket's warm plan keys: all hits after warmup;
        an evicted entry is re-pinned from the warmup snapshot.  With a
        tuner, also probe the bucket's tuning keys."""
        if bucket is None or bucket not in self._bucket_plans:
            return {"probed": 0, "missing": 0}
        snapshot = self._bucket_plans[bucket]
        missing = [k for k in snapshot if plan_cache.get(k) is None]
        for k in missing:
            if snapshot[k] is not None:
                plan_cache.put(k, snapshot[k])
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


def _read_device_times(g: _BucketGraphs, pairs: List) -> None:
    """After a batch's last step (its tokens are on the host, so every
    event has completed): each decode step's device time and the gaps
    between steps from ``pairs``, and the in-graph span times of the last
    replay of each of the bucket's steps (``Server`` module docstring)."""
    step_h = obs.histogram("serve.decode_step.device_us")
    gap_h = obs.histogram("serve.between_steps.device_us")
    for start, end in pairs:
        step_h.observe(start.elapsed_time(end) * 1e3)
    for (_, end), (start, _) in zip(pairs, pairs[1:]):
        gap_h.observe(end.elapsed_time(start) * 1e3)
    for name, step in g.steps.items():
        if not step.replays:
            continue
        prefix = "serve.graph." if name == "decode" else f"serve.graph.{name}."
        for span, us in obs.graph_times_us(step.events).items():
            obs.histogram(f"{prefix}{span}_us").observe(us)


def _zero(cache: Dict) -> None:
    """Zero every leaf of the cache: K/V, MLA latents, recurrent states and
    cross-attention K/V alike."""
    for t in tree_leaves(cache):
        t.zero_()


def warmup(model, params, cfg: ServeConfig, *, mesh=None, strategy: Optional[str] = None,
           tuning=None, buckets: Sequence = DEFAULT_BUCKETS) -> Server:
    """Build a ``Server`` and warm its buckets in one call; the per-bucket
    report is kept as ``server.warmup_report``."""
    server = Server(model, params, cfg, mesh=mesh, strategy=strategy, tuning=tuning,
                    buckets=buckets)
    server.warmup_report = server.warmup()
    return server
