"""The port's layers against the JAX package's, on the CPU, in fp32.

Parameters are the JAX smoke model's, passed through ``params_from_jax``;
activations come from a seeded numpy generator.  Tolerance: 1e-5 of the
output's largest magnitude (both sides compute in fp32; only the order of
sums differs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.layers import attention as jattn
from repro.layers import embed as jembed
from repro.layers.mlp import mlp as jax_mlp
from repro.layers.norms import rms_norm as jax_rms_norm
from repro.layers.rope import apply_rope as jax_apply_rope
from repro.models.registry import build_model as jax_build_model
from repro_torch.checkpoint import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.layers import attention, embed
from repro_torch.models.registry import build_model
from repro_torch.layers.mlp import mlp
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rope import apply_rope

TOL = 1e-5
CPU = torch.device("cpu")


def _close(port, ref, tol=TOL):
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.max(np.abs(port - ref)) / (np.max(np.abs(ref)) + 1e-12)
    assert err < tol, err


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def model_pair():
    """(jax cfg, port cfg, jax layer-0 params, port layer-0 params)."""
    jcfg = dataclasses.replace(jax_smoke_config("llama3_2_1b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    jl0 = jax.tree.map(lambda a: a[0], jparams["layers"])
    return jcfg, tcfg, jl0, tparams["layers"][0]


def test_rms_norm(model_pair):
    jcfg, _, jl0, tl0 = model_pair
    x = _np(0, 2, 5, 64)
    ref = jax_rms_norm(jnp.asarray(x), jl0["attn_norm"] * 1.5, jcfg.norm_eps)
    _close(rms_norm(torch.from_numpy(x), tl0["attn_norm"] * 1.5, jcfg.norm_eps), ref)


@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_with_negative_positions(batched):
    x = _np(1, 2, 6, 4, 16)
    pos = np.arange(6) - 2                       # left-padding slots < 0
    if batched:
        pos = pos[None, :] - np.array([[0], [3]])
    ref = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0), ref)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_unembed_masks_padded_vocab(tie):
    vocab, d = 300, 64                          # pads to 512 columns
    jp = jembed.embed_params(jax.random.PRNGKey(3), vocab, d, tie, jnp.float32)
    tp = {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in jp.items()}
    tokens = np.random.default_rng(4).integers(0, vocab, size=(2, 7))
    _close(embed.embed(tp, torch.from_numpy(tokens)),
           jembed.embed(jp, jnp.asarray(tokens)))
    x = _np(5, 2, 7, d)
    ref = np.asarray(jembed.unembed(jp, jnp.asarray(x), vocab))
    out = embed.unembed(tp, torch.from_numpy(x), vocab)
    assert out.shape == (2, 7, 512) and out.dtype == torch.float32
    assert torch.all(out[..., vocab:] == -1e30) and np.all(ref[..., vocab:] == -1e30)
    _close(out[..., :vocab], ref[..., :vocab])


def test_mlp(model_pair):
    _, _, jl0, tl0 = model_pair
    x = _np(6, 2, 5, 64)
    _close(mlp(tl0["mlp"], torch.from_numpy(x)), jax_mlp(jl0["mlp"], jnp.asarray(x)))


@pytest.mark.parametrize("causal, probs, tol", [
    (True, "fp32", TOL), (False, "fp32", TOL),
    # bf16 probabilities: a 1e-7 difference in a softmax value can round it
    # to the neighbouring bf16 value (2^-8 relative) on one side only
    (True, "bf16", 2e-2)])
def test_gqa_attention_uncached_chunked(model_pair, causal, probs, tol):
    """S = 64 > attn_chunk = 32: the chunk loop."""
    jcfg, tcfg, jl0, tl0 = model_pair
    jcfg, tcfg = (dataclasses.replace(c, attn_probs_dtype=probs) for c in (jcfg, tcfg))
    x = _np(7, 2, 64, 64)
    pos = np.arange(64)
    ref, _ = jattn.gqa_attention(jl0["attn"], jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 causal=causal)
    out, cache = attention.gqa_attention(tl0["attn"], torch.from_numpy(x), tcfg,
                                         torch.from_numpy(pos), causal=causal)
    assert cache is None
    _close(out, ref, tol)


@pytest.mark.parametrize("with_offsets", [False, True])
def test_gqa_attention_prefill_then_cached_decode(model_pair, with_offsets):
    """Prefill 8 slots of a 16-slot cache, then 3 decode steps; outputs and
    the cache contents (written in place on the port side) agree.  With
    offsets the rows are left-padded by 0 and 3 slots."""
    jcfg, tcfg, jl0, tl0 = model_pair
    b, s, slots = 2, 8, 16
    off = np.array([0, 3]) if with_offsets else None
    jcache = jattn.gqa_cache(jcfg, b, slots, jnp.float32)
    tcache = attention.gqa_cache(tcfg, b, slots, torch.float32, CPU)
    pos = np.arange(s) if off is None else np.arange(s)[None, :] - off[:, None]
    x = _np(8, b, s, 64)
    jo = jnp.asarray(off) if off is not None else None
    to = torch.from_numpy(off) if off is not None else None
    ref, jcache = jattn.gqa_attention(jl0["attn"], jnp.asarray(x), jcfg,
                                      jnp.asarray(pos), jcache, jnp.int32(0),
                                      offsets=jo)
    out, tcache = attention.gqa_attention(tl0["attn"], torch.from_numpy(x), tcfg,
                                          torch.from_numpy(pos), tcache, 0, offsets=to)
    _close(out, ref)
    for t in range(s, s + 3):
        xt = _np(100 + t, b, 1, 64)
        qpos = np.full((1,), t) if off is None else t - off[:, None]
        ref, jcache = jattn.gqa_attention(jl0["attn"], jnp.asarray(xt), jcfg,
                                          jnp.asarray(qpos), jcache, jnp.int32(t),
                                          offsets=jo)
        out, tcache = attention.gqa_attention(tl0["attn"], torch.from_numpy(xt), tcfg,
                                              torch.from_numpy(qpos), tcache, t,
                                              offsets=to)
        _close(out, ref)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_gqa_attention_rolling_window_cache(model_pair):
    """Sliding window 4 with a 4-slot rolling cache, decoded one token at
    a time past the wrap."""
    jcfg, tcfg, jl0, tl0 = model_pair
    jcfg, tcfg = (dataclasses.replace(c, window=4) for c in (jcfg, tcfg))
    jcache = jattn.gqa_cache(jcfg, 2, 32, jnp.float32)
    tcache = attention.gqa_cache(tcfg, 2, 32, torch.float32, CPU)
    assert tuple(tcache["k"].shape) == jcache["k"].shape == (2, 4, 2, 16)
    for t in range(7):
        xt = _np(200 + t, 2, 1, 64)
        ref, jcache = jattn.gqa_attention(jl0["attn"], jnp.asarray(xt), jcfg,
                                          jnp.full((1,), t), jcache, jnp.int32(t))
        out, tcache = attention.gqa_attention(tl0["attn"], torch.from_numpy(xt), tcfg,
                                              torch.full((1,), t), tcache, t)
        _close(out, ref)


def test_cache_write_past_end_raises(model_pair):
    _, tcfg, _, tl0 = model_pair
    cache = attention.gqa_cache(tcfg, 1, 8, torch.float32, CPU)
    x = torch.from_numpy(_np(9, 1, 4, 64))
    with pytest.raises(ValueError, match="overruns"):
        attention.gqa_attention(tl0["attn"], x, tcfg, torch.arange(6, 10), cache, 6)


@pytest.fixture(scope="module")
def danube_models():
    """(jax model, jax params, port model, port params): the fp32 danube
    smoke model, window 16, so a cache of max_seq >= 16 rolls."""
    jcfg = dataclasses.replace(jax_smoke_config("h2o-danube-3-4b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("h2o-danube-3-4b"), dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def test_multi_token_write_into_rolling_cache_raises(danube_models):
    """The reference's slot positions, pos - mod(pos - idx, W), are right
    for one token at a time: an 8-token prefill at pos 0 puts every slot
    after the first at a negative position and masks it.  The port refuses."""
    _, _, tmodel, tparams = danube_models
    cache = tmodel.init_cache(1, 32, CPU)
    assert cache["layers"][0]["k"].shape[1] == 16          # rolling: window slots
    tokens = torch.from_numpy(np.random.default_rng(10).integers(0, 256, size=(1, 8)))
    with pytest.raises(ValueError, match="rolling"):
        tmodel.prefill(tparams, cache, tokens)


def test_rolling_decode_matches_reference_and_uncached_forward(danube_models):
    """Prefill 1 token into the 16-slot rolling cache, then decode 23 steps,
    7 past the wrap: every step's logits agree with the reference's cached
    decode and with the uncached forward over the same 24 tokens."""
    jmodel, jparams, tmodel, tparams = danube_models
    tokens = np.random.default_rng(11).integers(0, 256, size=(2, 24))
    full, _ = tmodel.forward(tparams, torch.from_numpy(tokens))
    jcache = jmodel.init_cache(2, 32)
    tcache = tmodel.init_cache(2, 32, CPU)
    ref, jcache = jmodel.prefill(jparams, jcache, jnp.asarray(tokens[:, :1]))
    out, tcache = tmodel.prefill(tparams, tcache, torch.from_numpy(tokens[:, :1]))
    _close(out, ref)
    _close(out, full[:, 0])
    decode = jax.jit(jmodel.decode_step)      # one trace for all 23 positions
    for t in range(1, 24):
        step = tokens[:, t:t + 1]
        ref, jcache = decode(jparams, jcache, jnp.asarray(step), jnp.int32(t))
        out, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(step), t)
        _close(out, ref)
        _close(out, full[:, t])
