"""The latent-attention cell (``v2lite-serve-azconv-b64``) on the CPU at
smoke sizes, through ``drivers/serve_latent.py`` and
``reference/latent_decoder.py``: a sound run comes out correct, and one
whose latent cache is perturbed, whose decode steps leave the cache
unchanged, or whose tokens are altered comes out not correct; the
reference equals the program in float32; the weights have the program's
layout; the traffic's lengths are the quantiles the cell's ``why``
gives."""
from __future__ import annotations

import copy
import math
import statistics
import time
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import harness, latent_weights, spec
from portbench.reference import latent_decoder
from portbench.tests.test_harness import _altered_tokens, smoke
from portbench.traffic import batches

CELL = "v2lite-serve-azconv-b64"
BENCH = spec.benchmark()
TOL = 1e-4   # float32 against float32: the same sums in other orders


def _run(ctx):
    m = spec.metrics_of(BENCH, CELL)
    return harness.run(ctx, m["end_to_end"], m["per_layer"], 0.2, False, time.perf_counter())


def test_the_cell_s_parts():
    wl = spec.workload_file(CELL)
    assert wl["driver"] == "serve_latent" and tuple(wl["bucket"]) == (64, 2048)
    assert wl["max_seq"] == 2048 + spec.traffic("batch64-azure-conv")["max_new_tokens"]
    cfg = spec.config("deepseek-v2-lite")
    assert cfg["reference"] == "latent_decoder" and cfg["reduced"] == []
    assert cfg["model"]["attn_type"] == "mla" and cfg["model"]["q_lora_rank"] == 0


def test_a_sound_run_is_correct():
    res = _run(smoke(CELL))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


def _perturbed_latent():
    """Every serving prefill's latent cache has noise added once written."""
    from repro_torch.layers import blocks

    real = blocks.mla_attention

    def attention(p, x, cfg, positions, cache=None, pos=None, **kw):
        out = real(p, x, cfg, positions, cache, pos, **kw)
        if cache is not None and x.shape[1] > 1:
            gen = torch.Generator().manual_seed(0)
            noise = torch.randn(cache["c_kv"].shape, generator=gen)
            cache["c_kv"].add_(noise.to(cache["c_kv"].dtype))
        return out
    return mock.patch.object(blocks, "mla_attention", attention)


def _latent_unchanged():
    """Every decode step writes into a copy of the latent cache."""
    from repro_torch.layers import blocks

    real = blocks.mla_attention

    def attention(p, x, cfg, positions, cache=None, pos=None, **kw):
        if cache is not None and x.shape[1] == 1:
            cache = {k: v.clone() for k, v in copy.copy(cache).items()}
        return real(p, x, cfg, positions, cache, pos, **kw)
    return mock.patch.object(blocks, "mla_attention", attention)


@pytest.mark.parametrize("fault", [_perturbed_latent, _latent_unchanged, _altered_tokens],
                         ids=["latent perturbed", "state unchanged", "token altered"])
def test_a_broken_path_is_not_correct(fault):
    with fault():
        res = _run(smoke(CELL))
    assert not res["correct"], res["checks"]


def test_the_control_is_told_apart():
    ctx = smoke(CELL)
    drv = spec.driver(ctx.workload["driver"]).Driver(ctx)
    drv.setup()
    drv.window(0.0)
    got = drv.check(control=True)
    assert got["control.logit_gap_mean"] >= 3 * got["logit_gap_mean"], got


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["published", "dropping"])
def test_the_reference_is_the_program_in_float32(capacity_factor):
    """A served batch (left-padded prompts, prefill, the served tokens fed
    back one a step) on the smoke model in float32, against
    ``served_logits``; at capacity 0.5 the prompt's groups drop choices,
    so the reference's routing and its padding queries are held to the
    program's."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.lm import DecoderLM

    m = dict(spec.config("deepseek-v2-lite")["smoke"], dtype="float32",
             capacity_factor=capacity_factor)
    params = latent_weights.make(m, 11, "cpu")
    tree = latent_weights.program_tree(params)
    model = DecoderLM(ModelConfig(**m))
    plen, new, max_seq = 32, 6, 40
    rng = np.random.default_rng(1)
    lens = [3, 17, 32, 9]
    prompts = torch.zeros(len(lens), plen, dtype=torch.int64)
    for i, n in enumerate(lens):
        prompts[i, plen - n:] = torch.from_numpy(rng.integers(0, 256, n))
    offsets = torch.tensor([plen - n for n in lens])
    fed = torch.from_numpy(rng.integers(0, 256, (len(lens), new - 1)))
    want = []
    with torch.no_grad():
        cache = model.init_cache(len(lens), max_seq, "cpu")
        logits, _ = model.prefill(tree, cache, prompts, offsets)
        want.append(logits)
        for t in range(new - 1):
            logits, _ = model.decode_step(tree, cache, fed[:, t:t + 1], torch.tensor(plen + t),
                                          offsets)
            want.append(logits)
    want = torch.stack(want, dim=1)
    got = latent_decoder.served_logits(params, m, prompts, offsets, fed, max_seq)
    assert (got - want).abs().max() < TOL * want.abs().max()
    if capacity_factor < 1:
        x = torch.randn(4, plen, m["d_model"], generator=torch.Generator().manual_seed(0))
        w = {k: v.float() for k, v in params["layers"][0]["moe"].items() if k != "shared"}
        _, _, kept = latent_decoder.route(x, w, m, [(0, plen, plen)], fp8=False)
        assert not kept.all()


def test_the_weights_have_the_program_s_layout():
    """The tree ``latent_weights`` makes has the leaves, shapes and types of
    ``DecoderLM.init``'s; ``refill`` draws a new seed into the same
    tensors."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.lm import DecoderLM

    m = spec.config("deepseek-v2-lite")["smoke"]
    params = latent_weights.make(m, 3, "cpu")
    mine = latent_weights.program_tree(params)
    theirs = DecoderLM(ModelConfig(**m)).init(torch.Generator().manual_seed(0), "cpu")

    def shapes(tree, path=()):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in shapes(v, path + (k,)).items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in shapes(v, path + (i,)).items()}
        return {path: (tuple(tree.shape), tree.dtype)}
    assert shapes(mine) == shapes(theirs)
    wq = mine["layers"][0]["attn"]["wq"]
    before = wq.clone()
    latent_weights.refill(params, 4)
    assert wq.data_ptr() == mine["layers"][0]["attn"]["wq"].data_ptr()
    assert not torch.equal(before, wq)
    assert abs(float(wq.float().std()) - m["d_model"] ** -0.5) < 0.02


def test_the_traffic_is_the_azure_conversation_quantiles():
    """Medians 1020 in (the lognormal's mean 1020 x exp(0.6 ** 2 / 2)), 64
    quantiles, the 8 longest cut to the 2048 bucket, mean 1121.9 after the
    cut; 129 tokens out."""
    tr = spec.traffic("batch64-azure-conv")
    assert abs(tr["prompt_mean"] - 1020 * math.exp(tr["prompt_sigma"] ** 2 / 2)) < 0.05
    lens = batches.lengths(tr)
    assert len(lens) == 64 and sum(n == 2048 for n in lens) == 8
    assert max(lens) == 2048 and min(lens) == 239
    assert abs(statistics.mean(lens) - 1121.9) < 0.05
    assert 1008 <= statistics.median(lens) <= 1032
    assert tr["max_new_tokens"] == 129
