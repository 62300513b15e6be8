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
