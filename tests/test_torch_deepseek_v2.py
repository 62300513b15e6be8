"""DeepSeek-V2-Lite on the port, against the plain reference
(``plain_deepseek_v2.py``) on the CPU, with no JAX.

The port's smoke model in float32 on seeded random weights (norms drawn
too, so a norm weight left out shows): an uncached forward, and a
left-padded serving prefill followed by decode steps through the latent
cache, against the reference's full forward on logits; the serving
prefill's route (the expanded latent cache, query chunk by query chunk)
against the absorbed decode core on the same cache; YaRN pinned at the
published numbers; the gate flag; the ``layer.mla`` counter and span.

Tolerances: in float32 the port and the reference compute the same
equations with sums in other orders, so logits agree to ``TOL`` (1e-4) of
their largest magnitude, as the benchmark's reference test holds them.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import plain_deepseek_v2 as plain  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.layers import attention, moe as moe_mod, rope  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime.serve import ServeConfig  # noqa: E402
from repro_torch.serve import Server  # noqa: E402

TOL = 1e-4
ARCH = "deepseek-v2-lite"
CPU = torch.device("cpu")


def _cfg(**over) -> ModelConfig:
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32", **over)


def _params(model, seed=0):
    """``model.init``'s weights with every norm drawn around 1."""
    params = model.init(torch.Generator().manual_seed(seed), CPU)
    gen = torch.Generator().manual_seed(seed + 1)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif "norm" in k:
                v.add_(0.2 * torch.randn(v.shape, generator=gen))
    for key in ("dense_layers", "layers"):
        for block in params[key]:
            perturb(block)
    params["final_norm"].add_(0.2 * torch.randn(params["final_norm"].shape, generator=gen))
    return params


def _close(got, want):
    v = want.shape[-1]
    err = (got[..., :v] - want).abs().max()
    assert err < TOL * want.abs().max(), float(err)


# -- the configuration ----------------------------------------------------------------------


def test_the_published_numbers():
    c = get_config(ARCH)
    assert (c.num_layers, c.d_model, c.num_heads, c.vocab_size, c.d_ff) == (27, 2048, 16, 102400,
                                                                             10944)
    assert (c.q_lora_rank, c.kv_lora_rank, c.qk_nope_dim, c.qk_rope_dim, c.v_head_dim) == (
        0, 512, 128, 64, 128)
    assert (c.num_experts, c.top_k, c.num_shared_experts, c.moe_d_ff, c.first_dense_layers) == (
        64, 6, 2, 1408, 1)
    assert not c.moe_renormalize and c.norm_eps == 1e-6
    y = c.yarn
    assert (c.rope_theta, y.factor, y.original_max_pos, y.beta_fast, y.beta_slow, y.mscale,
            y.mscale_all_dim) == (1e4, 40, 4096, 32, 1, 0.707, 0.707)
    # 15.7 B parameters (the model card's count), 31.4 GB in bf16
    assert abs(c.param_count() / 1e9 - 15.7) < 0.01
    # a port-only configuration: outside the reference's (arch x shape) grid
    assert "deepseek_v2_lite" not in ARCHS


def test_a_direct_query_projection_and_its_count():
    """``q_lora_rank`` 0: one ``wq`` (d, H (nope + rope)), no query LoRA or
    norm, and ``param_count`` counts the tree ``init`` makes."""
    cfg = _cfg()
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0), CPU)
    attn = p["layers"][0]["attn"]
    assert set(attn) == {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert tuple(attn["wq"].shape) == (64, 4 * (16 + 8))
    assert sum(t.numel() for t in attn.values()) == cfg._attn_params()
    leaves = [t for t in _leaves(p)]
    vp = p["embed"]["embedding"].shape[0]
    assert sum(t.numel() for t in leaves) - 2 * (vp - cfg.vocab_size) * cfg.d_model == (
        cfg.param_count())
    lora = get_smoke_config("minicpm3-4b")
    assert set(attention.mla_params(torch.Generator().manual_seed(0), lora, torch.float32,
                                    CPU)) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
                                              "wkv_b", "wo"}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# -- YaRN ---------------------------------------------------------------------------------


def test_yarn_at_the_published_numbers():
    """D 64, theta 1e4, factor 40 over 4096, beta 32 / 1: the ramp runs over
    pairs 10..23; ``inv_freq`` is an independent float64 computation's; the
    softmax scale 192 ** -0.5 x (0.1 x 0.707 x ln 40 + 1) ** 2 = 0.114721;
    cos and sin scaled by 1 (mscale equals mscale_all_dim)."""
    y = get_config(ARCH).yarn
    assert rope.yarn_correction_range(y, 64, 1e4) == (10, 23)
    i = np.arange(32, dtype=np.float64)
    extra = 1e4 ** (-2 * i / 64)
    ramp = np.clip((i - 10) / 13, 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    got = rope.rope_freqs(64, 1e4, yarn=y).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the fast pairs keep plain RoPE's frequencies, the slow ones are divided by 40
    assert torch.equal(rope.rope_freqs(64, 1e4, yarn=y)[:11], rope.rope_freqs(64, 1e4)[:11])
    np.testing.assert_allclose(got[23:], extra[23:] / 40, rtol=1e-6)
    assert abs(attention.mla_scale(get_config(ARCH)) - 0.114721) < 5e-7
    assert abs(attention.mla_scale(get_config(ARCH))
               - 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2) < 1e-12
    assert rope.yarn_mscale(40, y.mscale) / rope.yarn_mscale(40, y.mscale_all_dim) == 1.0
    x = torch.randn(2, 5, 3, 64, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)
    ang = pos.double()[:, None] * torch.from_numpy(want)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :32].double(), x[..., 32:].double()
    ref = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    assert (rope.apply_rope(x, pos, 1e4, y).double() - ref).abs().max() < 1e-5


def test_the_plain_rope_path_is_bitwise_unchanged():
    """No YaRN fields: the frequencies and the rotation the port had."""
    x = torch.randn(2, 7, 4, 16, generator=torch.Generator().manual_seed(1)).bfloat16()
    pos = torch.arange(7)[None, :] - torch.tensor([[0], [3]])
    exps = torch.arange(0, 16, 2, dtype=torch.float32) / 16
    freqs = 1.0 / (5e5 ** exps)
    ang = pos.to(torch.float32)[..., None] * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :8].float(), x[..., 8:].float()
    want = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)
    assert torch.equal(rope.rope_freqs(16, 5e5), freqs)
    assert torch.equal(rope.apply_rope(x, pos, 5e5), want)
    assert get_config("minicpm3-4b").yarn is None
    assert attention.mla_scale(get_config("minicpm3-4b")) == 1.0 / math.sqrt(64 + 32)


# -- the model against the plain reference ------------------------------------------------


def test_uncached_forward_matches_the_plain_reference():
    cfg = _cfg()
    model = build_model(cfg)
    params = _params(model)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64)))
    with torch.no_grad():
        got, _ = model.forward(params, tokens)
    _close(got, plain.forward(params, dataclasses.asdict(cfg), tokens)[..., :cfg.vocab_size])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["published", "dropping"])
def test_served_prefill_then_decode_matches_the_plain_full_forward(capacity_factor):
    """Left-padded prompts in a 32-token bucket, ``prefill`` (the cached
    multi-token route), then 6 decode steps through a 40-slot latent cache
    (the absorbed route): each step's logits against the reference's full
    forward over prompt and fed tokens.  At capacity 0.5 choices are
    dropped in the prompt's groups, padding tokens included, so the
    padding queries' mean over the cache is held too."""
    cfg = _cfg(capacity_factor=capacity_factor)
    model = build_model(cfg)
    params = _params(model, 3)
    plen, new, max_seq = 32, 6, 40
    rng = np.random.default_rng(1)
    lens = [3, 17, 32, 9]
    prompts = torch.zeros(len(lens), plen, dtype=torch.int64)
    for i, n in enumerate(lens):
        prompts[i, plen - n:] = torch.from_numpy(rng.integers(0, 256, n))
    offsets = torch.tensor([plen - n for n in lens])
    fed = torch.from_numpy(rng.integers(0, 256, (len(lens), new - 1)))
    got = []
    with torch.no_grad():
        cache = model.init_cache(len(lens), max_seq, CPU)
        logits, _ = model.prefill(params, cache, prompts, offsets)
        got.append(logits)
        for t in range(new - 1):
            logits, _ = model.decode_step(params, cache, fed[:, t:t + 1], torch.tensor(plen + t),
                                          offsets)
            got.append(logits)
    got = torch.stack(got, dim=1)
    m = dataclasses.asdict(cfg)
    want = plain.forward(params, m, torch.cat([prompts, fed], dim=1), offsets, plen, max_seq)
    _close(got, want[:, plen - 1:, :cfg.vocab_size])
    if capacity_factor < 1:
        x = torch.randn(4, plen, cfg.d_model, generator=torch.Generator().manual_seed(2))
        w = plain._fp32(params["layers"][0]["moe"])
        _, _, kept = plain.route(x, w, m, [(0, plen, plen)])
        assert not kept.all()


def test_the_server_serves_the_reference_s_best_tokens():
    """``Server.generate`` on bucket 4x16 (left padding, the captured path's
    eager twin on the CPU): each greedy token is the argmax of the
    reference's logits at its position."""
    cfg = _cfg()
    model = build_model(cfg)
    params = _params(model, 5)
    srv = Server(model, params, ServeConfig(max_new_tokens=5, max_seq=24), buckets=[(4, 16)])
    srv.warmup()
    prompts = [[5, 6, 7], [9, 2, 3, 4, 1], [17, 3], [8] * 11]
    res = srv.generate(prompts)
    assert res.bucket == "4x16"
    offsets = torch.tensor([16 - len(p) for p in prompts])
    toks = torch.zeros(4, 16, dtype=torch.int64)
    for i, p in enumerate(prompts):
        toks[i, 16 - len(p):] = torch.tensor(p)
    served = torch.tensor(res.new_tokens)
    want = plain.forward(params, dataclasses.asdict(cfg), torch.cat([toks, served[:, :-1]], 1),
                         offsets, 16, 24)[:, 15:, :cfg.vocab_size]
    assert torch.equal(want.argmax(-1), served)


@pytest.mark.parametrize("dtype, tol", [
    ("float32", 1e-5),
    # bf16 operands read alike on both routes, sums in fp32; the last
    # rounding of each output to bf16 can differ by one unit (2 ** -8)
    ("bfloat16", 2 ** -8)])
def test_the_prefill_route_matches_the_absorbed_core(dtype, tol):
    """A cached write of 16 tokens at slot 0 of a 24-slot latent cache, with
    left padding: the expanded route's output against the absorbed core
    (``latent_core``) computed on the same cache and queries, row by row."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    model = build_model(cfg)
    p = _params(model, 7)["layers"][0]["attn"]
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(3, 16, cfg.d_model, generator=gen).to(dt)
    off = torch.tensor([0, 5, 12])
    pos = torch.arange(16)[None, :] - off[:, None]
    cache = attention.mla_cache(cfg, 3, 24, dt, CPU)
    with torch.no_grad():
        out, cache = attention.mla_attention(p, x, cfg, pos, cache, 0, offsets=off)
        q_nope, q_rope = attention._mla_q(p, x, cfg, pos)
        core = attention.latent_core(q_nope, q_rope, cache, p["wkv_b"], pos, off,
                                     attention.mla_scale(cfg)).to(dt)
        want = attention.linear(core.reshape(3, 16, -1), p["wo"])
    rel = (out.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)
    assert rel.max() < tol, float(rel.max())


def test_a_prefill_in_dispatch_slices_is_the_one_pass(monkeypatch):
    """The MoE's routing groups in slices of ``DISPATCH_TOKENS`` (here 64
    tokens, two groups of 32: a left-padded serving prefill of 4 x 32
    tokens in two slices): the one pass's logits, latent caches and
    load-balancing loss, then the same decode step."""
    prompts = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (4, 32)))
    offsets = torch.tensor([0, 7, 31, 12])
    model = build_model(_cfg(capacity_factor=0.5))
    params = _params(model, 9)
    x = torch.randn(4, 32, model.cfg.d_model, generator=torch.Generator().manual_seed(3))
    out = []
    for budget in (moe_mod.DISPATCH_TOKENS, 64):
        monkeypatch.setattr(moe_mod, "DISPATCH_TOKENS", budget)
        cache = model.init_cache(4, 40, CPU)
        with torch.no_grad():
            first, _ = model.prefill(params, cache, prompts, offsets)
            step, _ = model.decode_step(params, cache, prompts[:, -1:], torch.tensor(32), offsets)
            y, aux = moe_mod.moe(params["layers"][0]["moe"], x, model.cfg)
        out.append((first, step, cache, y, aux))
    (a, sa, ca, ya, xa), (b, sb, cb, yb, xb) = out
    assert (a - b).abs().max() <= 1e-6 * a.abs().max()
    assert (sa - sb).abs().max() <= 1e-6 * sa.abs().max()
    for la, lb in zip(ca["dense_layers"] + ca["layers"], cb["dense_layers"] + cb["layers"]):
        for k in la:
            assert (la[k] - lb[k]).abs().max() <= 1e-6 * la[k].abs().max()
    assert (ya - yb).abs().max() <= 1e-6 * ya.abs().max()
    assert abs(float(xa - xb)) <= 1e-6 * float(xa)


# -- the gate flag --------------------------------------------------------------------------


def test_the_gate_flag_s_default_leaves_deepseek_moe_bitwise():
    """deepseek-moe-16b keeps renormalised gates (the default); the layer
    with the flag off and the top-k renormalised by hand is bitwise the
    default layer, so the flag changes that division and nothing else; off,
    the gates are the top-k probabilities as they are."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"), dtype="float32")
    assert cfg.moe_renormalize and get_config("deepseek-moe-16b").moe_renormalize
    p = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)["layers"][0]["moe"]
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator().manual_seed(1))
    default, aux = moe_mod.moe(p, x, cfg)
    off = dataclasses.replace(cfg, moe_renormalize=False)
    real = moe_mod.top_k

    def renormalised(v, k):
        vals, idx = real(v, k)
        return vals / vals.sum(dim=-1, keepdim=True).clamp(min=1e-9), idx
    moe_mod.top_k = renormalised
    try:
        by_hand, aux2 = moe_mod.moe(p, x, off)
    finally:
        moe_mod.top_k = real
    assert torch.equal(default, by_hand) and torch.equal(aux, aux2)
    raw, _ = moe_mod.moe(p, x, off)
    assert not torch.allclose(raw, default)


# -- tracing -------------------------------------------------------------------------------


def test_mla_routes_are_counted_and_the_core_is_a_span():
    """One ``uncached`` call a layer in a forward, one ``cached_prefill`` a
    layer in a serving prefill, one ``absorbed`` a layer in each decode
    step; a ``layer.mla.latent_core`` span a layer a decode step, inside
    ``layer.attention_core``, and none in the prefill."""
    cfg = _cfg()
    model = build_model(cfg)
    params = _params(model)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 16)))
    layers = cfg.num_layers

    def counter():
        return obs.counter("layer.mla.calls")
    obs.reset()
    obs.reset_metrics()
    obs.enable()
    try:
        with torch.no_grad():
            model.forward(params, tokens)
            assert counter().items() == {(("route", "uncached"),): layers}
            obs.reset_metrics()
            cache = model.init_cache(2, 20, CPU)
            model.prefill(params, cache, tokens, torch.tensor([0, 4]))
            assert counter().items() == {(("route", "cached_prefill"),): layers}
            assert obs.get_recorder().span_counts().get("layer.mla.latent_core", 0) == 0
            for t in range(2):
                model.decode_step(params, cache, tokens[:, :1], torch.tensor(16 + t),
                                  torch.tensor([0, 4]))
    finally:
        obs.disable()
    assert counter().value(route="absorbed") == 2 * layers
    assert counter().value(route="cached_prefill") == layers
    spans = obs.get_recorder().spans
    core = [s for s in spans if s.name == "layer.mla.latent_core"]
    assert len(core) == 2 * layers
    by_id = {s.id: s for s in spans}
    assert all(by_id[s.parent].name == "layer.attention_core" for s in core)
    obs.reset()
    obs.reset_metrics()
