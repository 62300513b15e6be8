"""The port's observability (``repro_torch.obs``) against ``repro.obs``, on the CPU.

The same sequence of calls goes through both packages' recorders and
metrics registries: counters, histograms and ``snapshot`` are equal, and
``to_trace_events`` / ``metrics_snapshot`` have the same structure
(timestamps, thread ids and the producer name aside).  Then the port's
own seams: rank threads inherit the caller's tags, the collective seam
records one rank's calls (so the obs multiset equals the trace's), the
matmul span, the plan cache and server counters, and the calibration
pass on a CPU thread mesh.  Every test starts and ends with the port's
recorder and registry empty and tracing off.
"""
import dataclasses
import json
from collections import Counter

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.obs.profile import MachineProfile as RefProfile
from repro.obs.profile import fit_alpha_beta as ref_fit
from repro_torch import obs
from repro_torch.dist import Mesh, _collectives
from repro_torch.obs.profile import LinkParams, MachineProfile
from repro_torch.plan import build_plan, cache_clear, execute_plan
from repro_torch.verify import trace_plan


@pytest.fixture(autouse=True)
def _fresh_recorders():
    for pkg in (obs, ref_obs):
        pkg.disable()
        pkg.reset()
        pkg.reset_metrics()
    yield
    for pkg in (obs, ref_obs):
        pkg.disable()
        pkg.reset()
        pkg.reset_metrics()


@pytest.fixture
def cpu_mesh():
    meshes = []

    def make(sizes, names=None):
        m = Mesh(sizes, names, device="cpu")
        meshes.append(m)
        return m

    yield make
    for m in meshes:
        m.close()


def _calls(pkg, seed):
    """A seeded sequence of spans, collectives, instants and metrics."""
    rng = np.random.default_rng(seed)
    with pkg.observe() as rec:
        for i in range(int(rng.integers(2, 5))):
            with pkg.span("plan.execute", strategy=["cannon", "summa"][i % 2], m=int(i)):
                with pkg.span("dist.prefetch", comm="hidden"):
                    pkg.record_collective("ppermute", 4, int(rng.integers(1, 99)),
                                          perm=[(0, 1), (1, 0), (2, 2)])
                pkg.record_collective("all_gather", 2, int(rng.integers(1, 99)))
                pkg.counter("dist.collective.count").inc(kind="ppermute")
                pkg.counter("dist.collective.words").inc(int(rng.integers(1, 9)), kind="psum")
                pkg.histogram("kernel.matmul.us").observe(float(rng.random()))
            pkg.instant("plan.built", strategy="cannon")
        pkg.counter("serve.requests").inc(3, bucket="4x16")
        pkg.counter("serve.tokens").inc(48)
    return rec


def test_disabled_mode_is_noop():
    assert not obs.enabled()
    s1 = obs.span("a", x=1)
    assert s1 is obs.span("b") is obs.NOOP_SPAN
    with s1:
        obs.record_collective("ppermute", 4, 64, perm=[(0, 1), (1, 0)])
        obs.instant("nothing")
        assert obs.current_tags() == {}
    rec = obs.get_recorder()
    assert rec.spans == [] and rec.collectives == [] and rec.instants == []


def test_disabled_seams_record_and_synchronise_nothing(cpu_mesh):
    """With tracing off, a planned product (its block products included)
    adds no span, no collective and no metric."""
    mesh = cpu_mesh((2, 2))
    a, b = torch.ones(8, 8), torch.ones(8, 8)
    execute_plan(build_plan(8, 8, 8, mesh=mesh, strategy="cannon"), a, b)
    assert obs.get_recorder().spans == [] and obs.get_recorder().collectives == []
    assert obs.snapshot() == {}


def test_span_nesting_and_tags():
    with obs.observe() as rec:
        with obs.span("outer", strategy="cannon", m=8):
            with obs.span("inner", m=16):
                assert obs.current_tags() == {"strategy": "cannon", "m": 16}
            with obs.span("inner"):
                pass
    assert [s.name for s in rec.spans] == ["inner", "inner", "outer"]
    assert {s.name: s.depth for s in rec.spans} == {"inner": 1, "outer": 0}
    assert rec.span_counts() == {"inner": 2, "outer": 1}
    assert not obs.enabled()


def test_a_thread_inherits_tags_only_inside_the_scope():
    import threading

    seen = {}

    def worker():
        with obs.inherited({"strategy": "ring_ag", "comm": "exposed"}):
            with obs.span("dist.prefetch", comm="hidden"):
                seen["inside"] = obs.current_tags()
        seen["after"] = obs.current_tags()

    with obs.observe():
        t = threading.Thread(target=worker)
        t.start()
        t.join(30)
    assert not t.is_alive()
    assert seen == {"inside": {"strategy": "ring_ag", "comm": "hidden"}, "after": {}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_reference(seed):
    """Counters, histograms and ``snapshot`` equal ``repro.obs.metrics``'
    on the same sequence of calls."""
    _calls(obs, seed)
    _calls(ref_obs, seed)
    assert obs.snapshot() == ref_obs.snapshot()
    assert obs.counter("dist.collective.words").items() == \
        ref_obs.counter("dist.collective.words").items()
    assert obs.histogram("kernel.matmul.us").summary() == \
        ref_obs.histogram("kernel.matmul.us").summary()


def _shape(event):
    """A trace event without its timestamps, thread and process ids."""
    return {k: v for k, v in event.items() if k not in ("ts", "dur", "tid", "pid")}


@pytest.mark.parametrize("seed", [0, 3])
def test_trace_events_have_the_reference_structure(seed, tmp_path):
    port = obs.to_trace_events(_calls(obs, seed))
    ref = ref_obs.to_trace_events(_calls(ref_obs, seed))
    assert set(port) == set(ref) and port["displayTimeUnit"] == ref["displayTimeUnit"]
    assert port["otherData"] == {**ref["otherData"], "producer": "repro_torch.obs"}
    key = lambda e: (e["name"], json.dumps(e, sort_keys=True))  # noqa: E731
    assert sorted(map(_shape, port["traceEvents"]), key=key) == \
        sorted(map(_shape, ref["traceEvents"]), key=key)
    path = obs.write_trace(str(tmp_path / "t.json"), obs.get_recorder())
    assert json.loads(open(path).read())["traceEvents"] == \
        json.loads(json.dumps(obs.to_trace_events()["traceEvents"]))


def test_metrics_snapshot_has_the_reference_envelope(tmp_path):
    port = obs.metrics_snapshot(_calls(obs, 5))
    ref = ref_obs.metrics_snapshot(_calls(ref_obs, 5))
    assert port == ref
    assert obs.collective_totals() == ref_obs.collective_totals()
    got = json.loads(open(obs.write_metrics(str(tmp_path / "m.json"))).read())
    assert got == json.loads(json.dumps(port, sort_keys=True))


def test_collective_multiset_keys():
    with obs.observe() as rec:
        with obs.span("plan.execute", strategy="summa"):
            obs.record_collective("all_gather", 4, 128)
            obs.record_collective("ppermute", 4, 64, perm=[(1, 0), (0, 1), (2, 2)])
    ag, pp = rec.collectives
    assert ag.key == ("all_gather", 4, 128, None)
    assert pp.key == ("ppermute", 4, 64, ((0, 1), (1, 0)))
    assert obs.collective_multiset(rec, strategy="summa") == Counter([ag.key, pp.key])
    assert obs.collective_multiset(rec, strategy="cannon") == Counter()


@pytest.mark.parametrize("strategy, sizes, names", [
    ("cannon", (2, 2), ("x", "y")), ("summa", (2, 2), ("x", "y")),
    ("ring_rs", (4,), ("t",)), ("pod25d", (2, 2, 2), ("pod", "x", "y"))])
def test_seam_records_one_rank_with_the_callers_tags(cpu_mesh, strategy, sizes, names):
    """Every rank thread calls the seam; only the lowest rank records, each
    record tagged with the strategy of the caller's ``plan.execute`` span,
    so the obs multiset is the trace's."""
    mesh = cpu_mesh(sizes, names)
    plan = build_plan(16, 16, 16, mesh=mesh, strategy=strategy, use_cache=False)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((16, 16), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((16, 16), dtype=np.float32))
    with obs.observe() as rec:
        out = execute_plan(plan, a, b)
    want = Counter(r.key for r in trace_plan(plan).records)
    assert obs.collective_multiset(rec, strategy=strategy) == want
    assert len(rec.collectives) == sum(want.values())
    assert {ev.tid for ev in rec.collectives} <= {s.tid for s in rec.spans
                                                  if s.name == "kernel.matmul"}
    assert obs.counter("dist.collective.count").total() == sum(want.values())
    assert rec.span_counts()["plan.execute"] == 1
    assert torch.allclose(out, a @ b, rtol=1e-4, atol=1e-4)


def test_prefetch_spans_mark_hidden_collectives(cpu_mesh):
    mesh = cpu_mesh((4,), ("t",))
    plan = build_plan(16, 16, 16, mesh=mesh, strategy="ring_ag", use_cache=False)
    with obs.observe() as rec:
        execute_plan(plan, torch.ones(16, 16), torch.ones(16, 16))
    comms = Counter(ev.comm for ev in rec.collectives)
    assert comms == {"hidden": 3}
    assert obs.collective_totals(rec)["ring_ag"]["ppermute"]["hidden_words"] == 3 * 64


def test_matmul_span_and_metrics_on_the_cpu():
    from repro_torch.kernels.matmul import matmul

    a, b = torch.ones(8, 32), torch.ones(32, 16)
    with obs.observe() as rec:
        out = matmul(a, b)
    assert torch.equal(out, a @ b)
    (span,) = rec.spans
    assert span.name == "kernel.matmul" and span.args["route"] == "plain"
    assert (span.args["m"], span.args["n"], span.args["k"]) == (8, 16, 32)
    snap = obs.snapshot()
    assert snap["kernel.matmul.flops"] == 2.0 * 8 * 16 * 32
    assert snap["kernel.matmul.us"]["count"] == 1
    assert "kernel.matmul.roofline_fraction" not in snap   # a card's metric only


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_each_product_of_a_training_step_is_one_span(remat):
    """Under grad a product runs through the registered op: its forward,
    dA and dB are one ``kernel.matmul`` span each, and ``"dots"``
    recomputes none of them."""
    from repro_torch.kernels.matmul import matmul
    from repro_torch.models.lm import remat as remat_block
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), remat=remat)
    x = torch.ones(8, 32, requires_grad=True)
    w1, w2 = torch.ones(32, 16, requires_grad=True), torch.ones(16, 8, requires_grad=True)
    with obs.observe() as rec:
        y = remat_block(lambda x, w1, w2: matmul(torch.relu(matmul(x, w1)), w2), cfg)(x, w1, w2)
        y.sum().backward()
    assert rec.span_counts() == {"kernel.matmul": 6}
    assert obs.snapshot()["kernel.matmul.us"]["count"] == 6


def test_build_plan_span_and_cache_counters(cpu_mesh):
    cache_clear()
    mesh = cpu_mesh((2, 2))
    with obs.observe() as rec:
        build_plan(64, 64, 64, mesh=mesh)
        build_plan(64, 64, 64, mesh=mesh)
    assert rec.span_counts() == {"plan.build": 2}
    snap = obs.snapshot()
    assert snap["plan.cache.miss"] == 1 and snap["plan.cache.hit"] == 1
    assert snap["plan.build_us"]["count"] == 1
    assert [name for name, *_ in rec.instants] == ["plan.built"]


def test_profile_json_crosses_packages(tmp_path):
    """A profile with the port's extra keys and an embedded tuning table
    loads in the reference (which ignores the extra keys) and back."""
    from repro_torch.tune import TunedBlocks, TuningTable

    table = TuningTable(device_kind="NVIDIA H100 80GB HBM3").with_entry(
        256, 256, 256, "bfloat16",
        TunedBlocks(128, 128, 64, "rowmajor", 1e-5, (256, 256, 256)))
    prof = MachineProfile(platform="cuda", peak_flops=6e14,
                          links=(("axis:x", LinkParams(3e-4, 9e11)),
                                 ("ici", LinkParams(2e-4, 1e12))),
                          created="t", tuning=table, device_kind="NVIDIA H100 80GB HBM3",
                          link_medium="device copies between rank threads")
    path = obs.save_profile(prof, str(tmp_path / "p.json"))
    back = obs.load_profile(path)
    assert back == prof and back.tuning.entries == table.entries
    ref = RefProfile.from_json(json.load(open(path)))
    assert ref.peak_flops == prof.peak_flops and ref.tuning.entries[0][1].block_n == 128
    again = MachineProfile.from_json(ref.to_json())
    assert again.links == prof.links and again.tuning.entries == table.entries


@pytest.mark.parametrize("sizes, times", [
    ((1e3, 1e5, 1e6), (1e-5, 2e-5, 1.1e-4)), ((4e3,), (2e-6,)),
    ((1e3, 1e6), (5e-5, 4e-5)), ((1e4, 1e5, 1e6, 1e7), (3e-4, 3.1e-4, 4e-4, 1.3e-3))])
def test_fit_alpha_beta_equals_the_reference(sizes, times):
    got, ref = obs.fit_alpha_beta(sizes, times), ref_fit(sizes, times)
    assert (got.alpha_s, got.bw_bytes_per_s) == (ref.alpha_s, ref.bw_bytes_per_s)


def test_probe_links_on_a_cpu_thread_mesh(cpu_mesh):
    mesh = cpu_mesh((2, 2))
    with obs.observe() as rec:
        prof = obs.probe_links(mesh, sizes_bytes=(1 << 12, 1 << 16), reps=1)
    names = {n for n, _ in prof.links}
    assert names == {"ici", "axis:x", "axis:y", "local"}
    assert prof.platform == "cpu" and prof.device_kind == "cpu"
    assert "rank threads" in prof.link_medium
    assert prof.peak_flops > 0 and all(p.bw_bytes_per_s > 0 for _, p in prof.links)
    assert rec.span_counts()["obs.calibrate"] == 1
    # ranking with it works on the same mesh
    assert build_plan(256, 256, 256, mesh=mesh, profile=prof, use_cache=False).strategy


def test_rank_failure_under_tracing_reaches_the_caller(cpu_mesh):
    mesh = cpu_mesh((2,), ("t",))

    def body(x):
        if _collectives.rank() == 1:
            raise ArithmeticError("rank 1")
        return _collectives.psum(x, "t")

    with obs.observe():
        with pytest.raises(ArithmeticError, match="rank 1"):
            mesh.run(body, {r: (torch.ones(2),) for r in range(2)})
