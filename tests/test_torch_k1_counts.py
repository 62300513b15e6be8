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
