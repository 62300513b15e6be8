"""The port's tracing at its layer boundaries, on the CPU.

``repro_torch.obs`` spans are ``torch.profiler`` ranges on the profiler's
clock, with ids, parents and the ``batch`` of the ``serve.generate`` they
run under; the model, the layers, the kernels and the server open them
where the work happens; a disabled span is the no-op singleton.  The
device-side parts (timing events inside a captured graph, K1's event
pairs) are driven here with stand-in events; ``tests/test_torch_cuda.py``
runs them on the card.  Every test starts and ends with tracing off and
the recorder and registry empty.
"""
import dataclasses
import statistics
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.matmul import ops as k1_ops
from repro_torch.models.registry import build_model
from repro_torch.roofline import hlo_stats
from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS
from repro_torch.runtime.serve import ServeConfig, decode_step
from repro_torch.serve import Server
from repro_torch.serve import server as server_mod

PROMPTS = [[5, 6, 7], [9, 2, 3, 4, 1], [17, 3], [8, 8, 8, 8, 8, 8, 1]]


@pytest.fixture(autouse=True)
def _fresh():
    obs.disable()
    obs.reset()
    obs.reset_metrics()
    yield
    obs.disable()
    obs.reset()
    obs.reset_metrics()


@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), dtype="float32")
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), "cpu")


def _host_events(prof, name):
    return sorted((e for e in prof.profiler.kineto_results.events() if e.name() == name),
                  key=lambda e: e.start_ns())


class _Boom:
    def __call__(self, *a, **k):
        raise AssertionError("a disabled span touched the profiler or the device")


class _FakeEvent:
    """A stand-in CUDA event: its record time is the order it was made in."""

    made = 0

    def __init__(self):
        _FakeEvent.made += 1
        self.t = _FakeEvent.made

    def elapsed_time(self, end):      # ms, as torch.cuda.Event
        return float(end.t - self.t)


# -- the recorder --------------------------------------------------------------------


def test_a_disabled_span_is_the_noop_singleton_and_makes_nothing(monkeypatch):
    monkeypatch.setattr(obs.runtime, "_record_function", _Boom())
    monkeypatch.setattr(obs.runtime, "_record_event", _Boom())
    with profile(activities=[ProfilerActivity.CPU]) as prof, obs.graph_events() as log:
        obs.span("layer.linear")                      # first call outside the measurement
        tracemalloc.start()
        for _ in range(50):
            s = obs.span("layer.linear")
            with s:
                pass
        snap = tracemalloc.take_snapshot()
        tracemalloc.stop()
    assert s is obs.NOOP_SPAN
    mine = snap.filter_traces([tracemalloc.Filter(True, obs.runtime.__file__)])
    assert mine.statistics("lineno") == []
    assert _host_events(prof, "layer.linear") == [] and log == []
    assert obs.get_recorder().spans == []


def test_an_enabled_span_is_a_profiler_range_on_the_profilers_clock():
    with obs.observe() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):            # the profiler's first ranges are slow to open
                with obs.span("warm"):
                    pass
            rec.clear()
            with obs.span("outer", batch=7):
                for _ in range(3):
                    with obs.span("inner"):
                        with obs.span("leaf"):
                            pass
    by_name = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    assert "warm" not in by_name
    offsets = []
    for name, spans in by_name.items():
        events = _host_events(prof, name)
        assert len(events) == len(spans)
        for s, e in zip(sorted(spans, key=lambda s: s.ts_us), events):
            assert s.ts_us <= e.start_ns() / 1e3 and e.end_ns() / 1e3 <= s.ts_us + s.dur_us
            offsets.append(e.start_ns() / 1e3 - s.ts_us)
    assert statistics.median(offsets) < 100.0, offsets
    (outer,) = by_name["outer"]
    assert outer.parent is None and outer.batch == 7
    ids = {s.id for s in rec.spans}
    assert len(ids) == len(rec.spans)
    for inner in by_name["inner"]:
        assert inner.parent == outer.id and inner.batch == 7 and inner.depth == 1
        (leaf,) = [s for s in by_name["leaf"] if s.parent == inner.id]
        assert leaf.batch == 7 and leaf.depth == 2


def test_the_exported_trace_lays_over_the_profilers(tmp_path):
    """Less the profiler trace's base, ``write_trace`` puts each span where
    the profiler's chrome trace puts its range."""
    import json

    with obs.observe() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):            # the profiler's first ranges are slow to open
                with obs.span("warm"):
                    pass
            for _ in range(3):
                with obs.span("layer.linear"):
                    pass
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    theirs = json.load(open(tmp_path / "prof.json"))
    ours = json.load(open(obs.write_trace(str(tmp_path / "obs.json"), rec)))
    base_us = theirs.get("baseTimeNanoseconds", 0) / 1e3
    want = sorted(e["ts"] + base_us for e in theirs["traceEvents"]
                  if e.get("name") == "layer.linear")
    got = sorted(e["ts"] for e in ours["traceEvents"] if e["name"] == "layer.linear")
    assert len(got) == len(want) == 3
    assert statistics.median(abs(g - w) for g, w in zip(got, want)) < 100.0, (got, want)


def test_a_rank_thread_carries_the_callers_batch():
    import threading

    seen = []

    def worker(tags):
        with obs.inherited(tags):
            with obs.span("kernel.matmul"):
                pass
        seen.append(True)

    with obs.observe() as rec:
        with obs.span("serve.generate", batch=3):
            t = threading.Thread(target=worker, args=(obs.current_tags(),))
            t.start()
            t.join(30)
    assert seen
    (k,) = [s for s in rec.spans if s.name == "kernel.matmul"]
    assert k.batch == 3 and k.parent is None


@pytest.mark.parametrize("enabled", [True, False])
def test_a_capture_times_model_and_layer_spans_only_with_tracing_on(monkeypatch, enabled):
    """Inside ``graph_events`` a ``model.*`` / ``layer.*`` span records a
    timing event at entry and exit (stand-ins here); other spans and a
    disabled recorder record none."""
    monkeypatch.setattr(obs.runtime, "_record_event", _FakeEvent)
    (obs.enable if enabled else obs.disable)()
    with obs.graph_events() as log:
        with obs.span("model.decode_step"):
            for _ in range(2):
                with obs.span("layer.attention"):
                    with obs.span("kernel.matmul"):
                        pass
    obs.disable()
    if not enabled:
        assert log == []
        return
    assert [name for name, _, _ in log] == ["layer.attention", "layer.attention",
                                            "model.decode_step"]
    # events: step start 1, attention 2-3 and 4-5, step end 6
    assert obs.graph_times_us(log) == {"layer.attention": 2e3, "model.decode_step": 5e3}
    with obs.observe():
        with obs.span("layer.linear"):
            pass
    assert len(log) == 3          # outside the scope, nothing more is recorded


def test_a_deferred_histogram_value_resolves_when_read():
    calls = []

    def later(v):
        def value():
            calls.append(v)
            return v
        return value

    h = obs.histogram("kernel.matmul.us")
    h.defer(later(3.0))
    h.defer(later(None))
    h.observe(1.0)
    assert calls == []
    assert obs.snapshot()["kernel.matmul.us"] == {"count": 2, "sum": 4.0, "min": 1.0,
                                                  "max": 3.0, "mean": 2.0}
    assert calls == [3.0, None]
    assert h.summary()["count"] == 2 and calls == [3.0, None]


# -- K1's roofline ---------------------------------------------------------------------


@pytest.mark.parametrize("m, n, k, out, bound", [
    # thin decode rows: bytes bound it
    (8, 4096, 4096, torch.bfloat16, "bytes"), (64, 10240, 3840, torch.float32, "bytes"),
    # wide prefill rows: operations bound it
    (8192, 8192, 8192, torch.bfloat16, "flops"), (32768, 3840, 3840, torch.bfloat16, "flops")])
def test_k1_bound_is_the_larger_of_operations_and_bytes(m, n, k, out, bound):
    got = k1_ops.bound_s(m, n, k, torch.bfloat16, out)
    flops = 2.0 * m * n * k / PEAK_FLOPS[torch.bfloat16]
    nbytes = ((m * k + k * n) * 2 + m * n * (4 if out == torch.float32 else 2)) / HBM_BW
    assert got == max(flops, nbytes)
    assert (flops > nbytes) == (bound == "flops")


def test_k1_bound_of_fp32_products_uses_the_fp32_peak():
    assert k1_ops.bound_s(4096, 4096, 4096, torch.float32, torch.float32) == \
        2.0 * 4096 ** 3 / PEAK_FLOPS[torch.float32]


def test_k1_launches_count_by_route_and_the_span_wraps_the_launch():
    from repro_torch.kernels.matmul import matmul

    a, b = torch.ones(8, 32), torch.ones(32, 16)
    with obs.observe() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            matmul(a, b)
            matmul(a, b)
    assert obs.snapshot()["kernel.matmul.launches{route=plain}"] == 2
    assert len(_host_events(prof, "kernel.matmul")) == len(rec.spans) == 2


def test_k2_launches_count_and_span_on_the_cpu():
    from repro_torch.kernels.flash_attention import mha

    q = torch.randn(1, 8, 2, 16)
    with torch.no_grad(), obs.observe() as rec:
        mha(q, q, q)
    (span,) = rec.spans
    assert span.name == "kernel.flash_attention" and span.args["route"] == "plain"
    assert obs.snapshot()["kernel.flash_attention.launches{route=plain}"] == 1


# -- the model and the layers ------------------------------------------------------------


def _chain(rec, leaf_name, names):
    """The span names from ``leaf_name``'s span up through its parents."""
    by_id = {s.id: s for s in rec.spans}
    out = []
    for leaf in (s for s in rec.spans if s.name == leaf_name):
        chain, s = [], leaf
        while s is not None:
            chain.append(s.name)
            s = by_id.get(s.parent)
        out.append(chain)
    return [c for c in out if c[:len(names)] == names]


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek-moe-16b", "minicpm3-4b"])
def test_the_decode_step_nests_model_attention_linear_and_kernel_spans(arch):
    model = build_model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    cache = model.init_cache(2, 16, "cpu")
    with torch.no_grad(), obs.observe() as rec:
        decode_step(model, params, cache, torch.ones((2, 1), dtype=torch.int64), 3)
    counts = rec.span_counts()
    n_layers = model.cfg.num_layers
    assert counts["model.decode_step"] == 1 and counts["layer.unembed"] == 1
    assert counts["layer.attention"] == counts["layer.attention_core"] == n_layers
    chains = _chain(rec, "kernel.matmul", ["kernel.matmul", "layer.linear", "layer.attention",
                                           "model.decode_step"])
    assert chains and all(c[-1] == "model.decode_step" for c in chains)
    if model.cfg.num_experts:
        assert counts["layer.moe"] == n_layers - model.cfg.first_dense_layers
        assert _chain(rec, "layer.linear", ["layer.linear", "layer.mlp", "layer.moe"])
    else:
        assert counts["layer.mlp"] == n_layers
    step = next(s for s in rec.spans if s.name == "model.decode_step")
    assert all(s.ts_us >= step.ts_us and s.ts_us + s.dur_us <= step.ts_us + step.dur_us
               for s in rec.spans)


def test_the_decode_route_counts_one_launch_a_layer_inside_the_attention_core(monkeypatch):
    """A decode step counts one ``kernel.decode_attention`` launch a layer,
    its span inside ``layer.attention_core``; a prefill counts none.  The
    kernel takes CUDA tensors only, so ``takes`` is patched to let the CPU
    through: the op's CPU implementation (route ``plain``) runs and counts
    as the kernel would."""
    from repro_torch.kernels import decode_attention

    monkeypatch.setattr(decode_attention, "takes", lambda q, k, v: True)
    model = build_model(get_smoke_config("llama3_2_1b"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    n_layers = model.cfg.num_layers
    with torch.no_grad(), obs.observe() as rec:
        model.prefill(params, model.init_cache(2, 16, "cpu"), torch.ones((2, 8), dtype=torch.int64))
        assert "kernel.decode_attention.launches{route=plain}" not in obs.snapshot()
        assert rec.span_counts().get("kernel.decode_attention", 0) == 0
        decode_step(model, params, model.init_cache(2, 16, "cpu"),
                    torch.ones((2, 1), dtype=torch.int64), 3)
    counts = rec.span_counts()
    assert obs.snapshot()["kernel.decode_attention.launches{route=plain}"] == n_layers
    assert counts["kernel.decode_attention"] == n_layers == counts["layer.attention_core"] // 2
    chains = _chain(rec, "kernel.decode_attention", ["kernel.decode_attention",
                                                     "layer.attention_core", "layer.attention",
                                                     "model.decode_step"])
    assert len(chains) == n_layers


@pytest.mark.parametrize("routed", [False, True])
def test_the_moe_route_counts_its_calls_and_one_kernel_span_a_moe_layer(monkeypatch, routed):
    """Every MoE call counts in ``layer.moe.calls{route}``: ``dense`` where
    ``moe_experts.takes`` refuses the tensors (the CPU), ``routed`` where it
    takes them (patched here to let the CPU through: the op's CPU
    implementation, route ``plain``, runs and counts as the kernel would),
    one ``kernel.moe_experts`` launch and span a MoE layer inside its
    ``layer.moe`` span, in a prefill and a decode step alike."""
    from repro_torch.kernels import moe_experts

    if routed:
        monkeypatch.setattr(moe_experts, "takes", lambda *a: True)
    model = build_model(get_smoke_config("deepseek-moe-16b"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    layers = model.cfg.num_layers - model.cfg.first_dense_layers
    cache = model.init_cache(2, 16, "cpu")
    with torch.no_grad(), obs.observe() as rec:
        model.prefill(params, cache, torch.ones((2, 8), dtype=torch.int64))
        decode_step(model, params, cache, torch.ones((2, 1), dtype=torch.int64), 8)
    snap, counts = obs.snapshot(), rec.span_counts()
    route = "routed" if routed else "dense"
    assert snap[f"layer.moe.calls{{route={route}}}"] == counts["layer.moe"] == 2 * layers
    assert not any(k.startswith("layer.moe.calls") and route not in k for k in snap)
    if not routed:
        assert counts.get("kernel.moe_experts", 0) == 0
        assert not any(k.startswith("kernel.moe_experts") for k in snap)
        return
    assert snap["kernel.moe_experts.launches{route=plain}"] == counts["kernel.moe_experts"]
    chains = _chain(rec, "kernel.moe_experts", ["kernel.moe_experts", "layer.moe"])
    assert len(chains) == counts["kernel.moe_experts"] == 2 * layers


def test_the_forward_and_prefill_have_one_attention_span_a_layer(smoke):
    model, params = smoke
    tokens = torch.ones((2, 8), dtype=torch.int64)
    with torch.no_grad(), obs.observe() as rec:
        model.forward(params, tokens)
        model.prefill(params, model.init_cache(2, 16, "cpu"), tokens)
    counts = rec.span_counts()
    n_layers = model.cfg.num_layers
    assert counts["model.forward"] == counts["model.prefill"] == 1
    assert counts["layer.attention"] == counts["layer.attention_core"] == 2 * n_layers
    assert counts["layer.linear"] == 2 * 7 * n_layers and counts["layer.unembed"] == 2
    for top in ("model.forward", "model.prefill"):
        (root,) = [s for s in rec.spans if s.name == top]
        assert sum(s.parent == root.id and s.name == "layer.attention"
                   for s in rec.spans) == n_layers


def test_the_cost_counter_counts_the_same_with_tracing_on(smoke):
    model, params = smoke

    def run():
        with hlo_stats.counting() as c, torch.no_grad():
            cache = model.init_cache(2, 16, "cpu")
            decode_step(model, params, cache, torch.ones((2, 1), dtype=torch.int64), 3)
            model.forward(params, torch.ones((2, 8), dtype=torch.int64))
        return c

    off = run()
    with obs.observe() as rec:
        on = run()
    assert rec.span_counts()["layer.linear"] > 0
    assert on.costs == off.costs and on.by_op == off.by_op and on.calls == off.calls
    assert on.shapes == off.shapes


# -- the server ------------------------------------------------------------------------


def test_the_server_serves_the_same_tokens_with_tracing_on_and_off(smoke):
    model, params = smoke
    srv = Server(model, params, ServeConfig(max_new_tokens=4, max_seq=32), buckets=[(4, 8)])
    srv.warmup()
    off = [srv.generate(p).new_tokens for p in (PROMPTS, PROMPTS[:2])]
    with obs.observe() as rec:
        on = [srv.generate(p).new_tokens for p in (PROMPTS, PROMPTS[:2])]
    assert on == off
    gens = [s for s in rec.spans if s.name == "serve.generate"]
    assert len(gens) == 2 and len({g.args["batch"] for g in gens}) == 2
    assert all(g.args["bucket"] == "4x8" for g in gens)
    for g in gens:
        inside = [s for s in rec.spans
                  if g.ts_us <= s.ts_us and s.ts_us + s.dur_us <= g.ts_us + g.dur_us]
        assert {s.batch for s in inside} == {g.args["batch"]}
        names = {s.name for s in inside}
        assert {"serve.prefill", "serve.decode_step", "serve.sample", "serve.token_sync",
                "model.prefill", "model.decode_step", "layer.attention"} <= names
    counts = rec.span_counts()
    assert counts["serve.sample"] == 2 * 4 and counts["serve.token_sync"] == 2 * 4
    assert all(s.batch is not None for s in rec.spans)


def test_the_server_reads_step_events_and_graph_events_once_a_batch():
    """``_read_device_times`` on stand-in events: each step's time, the gaps
    between steps, and each in-graph span's time in the last replay."""
    ev = [_FakeEvent() for _ in range(12)]
    step = server_mod._Step("decode", None, None, {}, {},
                            events=[("model.decode_step", ev[0], ev[5]),
                                    ("layer.attention", ev[1], ev[2]),
                                    ("layer.attention", ev[3], ev[4])], replays=3)
    prefill = server_mod._Step("prefill", None, None, {}, {},
                               events=[("model.prefill", ev[6], ev[7])], replays=1)
    unreplayed = server_mod._Step("other", None, None, {}, {},
                                  events=[("model.prefill", ev[6], ev[7])])
    g = server_mod._BucketGraphs(None, None, None, None, {},
                                 steps={"prefill": prefill, "decode": step,
                                        "other": unreplayed})
    pairs = [(ev[8], ev[9]), (ev[10], ev[11])]
    with obs.observe():
        server_mod._read_device_times(g, pairs)
    snap = obs.snapshot()
    assert snap["serve.decode_step.device_us"]["sum"] == 2e3
    assert snap["serve.decode_step.device_us"]["count"] == 2
    assert snap["serve.between_steps.device_us"] == {"count": 1, "sum": 1e3, "min": 1e3,
                                                     "max": 1e3, "mean": 1e3}
    assert snap["serve.graph.model.decode_step_us"]["sum"] == 5e3
    assert snap["serve.graph.layer.attention_us"] == {"count": 1, "sum": 2e3, "min": 2e3,
                                                      "max": 2e3, "mean": 2e3}
    assert snap["serve.graph.prefill.model.prefill_us"]["sum"] == 1e3
    assert not any(k.startswith("serve.graph.other") for k in snap)
