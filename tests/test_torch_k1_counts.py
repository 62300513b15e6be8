"""``chip_smoke.py``'s K1 counts against the port's own calls, on the CPU.

The chip run asserts that a served forward launches K1
``chip_smoke.k1_per_step(cfg)`` times a step and a training forward
``chip_smoke.train_products(cfg)`` times.  Here every config's smoke
version runs one prefill, one decode step and one training forward on the
CPU with ``ops._run`` (where every K1 call launches: each projection's
product and the unembedding's) wrapped to count its calls, and each count
is held to those helpers: qwen3-moe's routed experts (einsums) add no
product to its 4 attention products a layer, deepseek-moe's dense layer
and shared experts add 3, and every forward adds the unembedding's one.
No JAX is involved.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.matmul import ops  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime.serve import decode_step, prefill  # noqa: E402

# a cache of SEQ + 4 slots stays below danube's smoke window (16), so the
# one-pass prefill writes a plain cache, not a rolling one
BATCH, SEQ = 2, 8


@pytest.fixture
def count_products(monkeypatch):
    """A list that gains one entry per K1 call (``ops._run``)."""
    calls = []
    real = ops._run

    def counting(a, b, *rest):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b, *rest)

    monkeypatch.setattr(ops, "_run", counting)
    return calls


def _smoke(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def _tokens(cfg, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(BATCH, SEQ)))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_served_step_runs_k1_per_step_products(arch, count_products):
    """One prefill of ``SEQ`` tokens (one pass, or one decode step a token)
    and one decode step, each counted against ``k1_per_step`` times its
    forward steps; the encoder-decoder's decode step after its cross K/V."""
    cfg, model, params = _smoke(arch)
    tokens = _tokens(cfg)
    per_step = chip_smoke.k1_per_step(cfg)
    with torch.no_grad():
        if cfg.family == "audio":
            cache = model.init_cache(BATCH, SEQ + 4, "cpu", src_len=16)
            src = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (BATCH, 16, cfg.d_model), dtype=np.float32))
            model.prefill_cross(params, model.encode(params, src), cache)
        else:
            cache = model.init_cache(BATCH, SEQ + 4, "cpu")
        count_products.clear()
        prefill(model, params, cache, tokens)
        assert len(count_products) == per_step * chip_smoke.prefill_steps(model, SEQ)
        count_products.clear()
        decode_step(model, params, cache, tokens[:, -1:], torch.tensor(SEQ))
        assert len(count_products) == per_step


@pytest.mark.parametrize("arch", ARCHS)
def test_a_training_forward_runs_train_products_products(arch, count_products):
    """``loss`` with gradients enabled (the training forward, no backward):
    ``train_products`` products, MLA's ``wkv_b`` and the encoder's and the
    decoder's cross K/V included."""
    cfg, model, params = _smoke(arch)
    tokens = _tokens(cfg)
    batch = {"tokens": tokens, "labels": _tokens(cfg, 1)}
    if cfg.family == "audio":
        batch["src_embed"] = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (BATCH, 16, cfg.d_model), dtype=np.float32))
    count_products.clear()
    model.loss(params, batch)
    assert len(count_products) == chip_smoke.train_products(cfg)


@pytest.mark.parametrize("arch, per_step, train", [
    ("qwen3-moe-30b-a3b", 4 * 48 + 1, 4 * 48 + 1),    # routed experts only: attention
    ("deepseek-moe-16b", 7 * 28 + 1, 7 * 28 + 1),     # a dense layer, then shared experts
    ("minicpm3-4b", 7 * 62 + 1, 8 * 62 + 1),          # MLA: wkv_b only uncached
    ("granite-20b", 7 * 52 + 1, 7 * 52 + 1), ("chameleon-34b", 7 * 48 + 1, 7 * 48 + 1)])
def test_the_published_configs_counts(arch, per_step, train):
    """The counts phases 15 and 20 hold the full models to: the layers'
    projections and the unembedding."""
    cfg = get_config(arch)
    assert (chip_smoke.k1_per_step(cfg), chip_smoke.train_products(cfg)) == (per_step, train)


def _trace_event(cat, name, ts, dur, corr, tid=None, stream=None):
    ev = {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}
    if tid is not None:
        ev["tid"] = tid
    if stream is not None:
        ev["args"]["stream"] = stream
    return ev


def test_hidden_share_reads_prefetch_copies_under_the_same_ranks_k1():
    """``chip_smoke.hidden_shares`` on a hand-made trace of two ranks
    (threads 11 and 12; compute streams 7 and 8, copy streams 20 and 21;
    the log keyed by stream handles the trace does not carry): a
    compute-stream memcpy is no ppermute copy, the logged issue order
    tells a skew (False) from a prefetch (True), each copy stream is
    paired with the compute stream its thread launched K1 on, and only K1
    time of the copy's own rank hides it.  Rank 11's prefetch (10 us) lies
    4 us under its K1 and 6 us more under rank 12's; rank 12's (10 us)
    10 us under its own."""
    ev = [
        # rank 11: a skew copy, a compute-stream memcpy, its prefetch, its K1
        _trace_event("cuda_runtime", "cudaMemcpyAsync", 0, 1, 1, tid=11),
        _trace_event("gpu_memcpy", "Memcpy DtoD", 100, 10, 1, stream=20),
        _trace_event("cuda_runtime", "cudaMemcpyAsync", 1, 1, 2, tid=11),
        _trace_event("gpu_memcpy", "Memcpy DtoD", 110, 10, 2, stream=7),
        _trace_event("cuda_runtime", "cudaMemcpyAsync", 2, 1, 3, tid=11),
        _trace_event("gpu_memcpy", "Memcpy DtoD", 200, 10, 3, stream=20),
        _trace_event("cuda_driver", "cuLaunchKernel", 3, 1, 4, tid=11),
        _trace_event("kernel", "zorder_matmul_wide_kernel<...>", 206, 50, 4, stream=7),
        # rank 12: its prefetch under its own K1, which also covers rank 11's
        _trace_event("cuda_runtime", "cudaMemcpyAsync", 2, 1, 5, tid=12),
        _trace_event("gpu_memcpy", "Memcpy DtoD", 200, 10, 5, stream=21),
        _trace_event("cuda_runtime", "cudaLaunchKernel", 3, 1, 6, tid=12),
        _trace_event("kernel", "zorder_matmul_wide_kernel<...>", 195, 16, 6, stream=8),
    ]
    got = chip_smoke.hidden_shares(ev, {1020: [False, True], 1021: [True]}, ranks=2)
    assert got["prefetch_copies"] == 2 and got["prefetch_copy_us"] == 20
    assert got["hidden"] == pytest.approx((4 + 10) / 20)
    assert got["under_any_k1"] == pytest.approx(1.0)
    with pytest.raises(AssertionError, match="no one logged issue order"):
        chip_smoke.hidden_shares(ev, {1020: [True, True], 1021: [False, True]}, ranks=2)


def _totals_by_key_averages(prof):
    """``chip_smoke.profile_totals``'s five tables through torch's own
    processing (``key_averages()``), the way ``profile_split`` read them
    before: the reference the raw-event reading is held to."""
    from collections import Counter

    kernels, counts, ops, op_calls, ranges = Counter(), Counter(), Counter(), Counter(), {}
    for e in prof.key_averages():
        host = str(e.device_type).endswith("CPU")
        if e.is_user_annotation:
            ranges.setdefault(e.key, {})["cpu" if host else "device"] = {
                "ms": float(e.device_time_total or 0) / 1e3, "count": e.count}
            continue
        us = float(e.self_device_time_total or 0)
        if not us:
            continue
        if not host:
            kernels[e.key] += us
            counts[e.key] += e.count
        elif "::" in e.key:
            ops[e.key] += us
            op_calls[e.key] += e.count
    return kernels, counts, ops, op_calls, ranges


def _assert_same_totals(got, want):
    """Every entry of the five tables equal (times to 1e-9 relative), all
    differences listed on failure."""
    diffs = []
    for g, w, what in zip(got, want, ("kernels", "launches", "operators", "calls", "ranges")):
        if set(g) != set(w):
            diffs.append((what, sorted(set(g) ^ set(w))))
        for key in set(g) & set(w):
            if what != "ranges":
                if g[key] != pytest.approx(w[key], rel=1e-9):
                    diffs.append((what, key, g[key], w[key]))
                continue
            for side in set(g[key]) | set(w[key]):
                a, b = g[key].get(side), w[key].get(side)
                if a is None or b is None or a["count"] != b["count"] or \
                        a["ms"] != pytest.approx(b["ms"], rel=1e-9, abs=1e-9):
                    diffs.append((what, key, side, a, b))
    assert not diffs, diffs


def _profiled_loss(device, arch, activities):
    """One training forward and backward of ``arch``'s smoke model under
    ``torch.profiler`` with the chip run's ranges: the unembedding's
    (``unembed_ranges``) and, around each SSD scan, ``ssd_chunk_scan``."""
    from torch.profiler import profile, record_function

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    leaves = [p for p in chip_smoke.tree_leaves(params) if p.is_floating_point()]
    for p in leaves:
        p.requires_grad_(True)
    batch = {"tokens": _tokens(cfg).to(device), "labels": _tokens(cfg, 1).to(device)}
    real = chip_smoke.mamba2_layer._ssd_chunk_scan

    def ranged(*args, **kw):
        with record_function("ssd_chunk_scan"):
            return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp, chip_smoke.unembed_ranges():
        mp.setattr(chip_smoke.mamba2_layer, "_ssd_chunk_scan", ranged)
        with profile(activities=activities) as prof:
            loss, _ = model.loss(params, batch)
            torch.autograd.grad(loss, leaves)
            if device.type == "cuda":
                torch.cuda.synchronize()
    return prof


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_profile_totals_are_key_averages_on_the_cpu(arch):
    """On the CPU the tables hold no device time: the ranges' calls and the
    empty kernel and operator tables are ``key_averages()``'s."""
    from torch.profiler import ProfilerActivity

    prof = _profiled_loss(torch.device("cpu"), arch, [ProfilerActivity.CPU])
    got = chip_smoke.profile_totals(prof)
    _assert_same_totals(got, _totals_by_key_averages(prof))
    assert got[4]["unembed"]["cpu"]["count"] == 1
    if arch == "zamba2-2.7b":
        assert got[4]["ssd_chunk_scan"]["cpu"]["count"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("host_side", [True, False], ids=["cpu+cuda", "cuda"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_profile_totals_are_key_averages_on_the_card(arch, host_side):
    """On the card: every kernel's time and launches, each operator's own
    kernels' time and calls (the unembedding's backward ``aten::mm`` among
    them), each range's calls, its kernels' time and its span, as
    ``key_averages()`` gives them."""
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_side else [])
    prof = _profiled_loss(torch.device("cuda"), arch, acts)
    got = chip_smoke.profile_totals(prof)
    _assert_same_totals(got, _totals_by_key_averages(prof))
    assert any("zorder_matmul" in k for k in got[0])
    if host_side:
        assert got[3]["aten::mm"] == 2 and got[2]["aten::mm"] > 0
        assert got[4]["unembed"]["cpu"]["ms"] > 0


def test_profile_totals_count_nested_ranges_as_key_averages():
    """A range alone inside one of its own name (once or twice over) counts
    once, as torch's event tree counts it; a range beside another event
    inside it counts twice."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with record_function("a"), record_function("a"):
                x @ x
            with record_function("b"), record_function("b"), record_function("b"):
                x + 1
            with record_function("c"):
                with record_function("c"):
                    x + 1
                x * 2
    got = chip_smoke.profile_totals(prof)
    _assert_same_totals(got, _totals_by_key_averages(prof))
    assert {k: r["cpu"]["count"] for k, r in got[4].items()} == {"a": 5, "b": 5, "c": 10}
