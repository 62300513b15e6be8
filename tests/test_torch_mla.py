"""The port's MLA attention (minicpm3) against the JAX package's, on the CPU,
in fp32.

Parameters are the JAX smoke model's first layer (``params_from_jax``),
activations come from a seeded numpy generator.  The reference's MLA never
reaches a Pallas kernel (its expanded path calls the chunked einsum core),
so it runs as is.  Tolerance: each output row within 1e-5 relative L2 of
the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.layers import attention as jattn
from repro.models.registry import build_model as jax_build_model
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.layers import attention
from repro_torch.models.registry import build_model

TOL = 1e-5
CPU = torch.device("cpu")


def row_rel(port, ref) -> float:
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    p, r = port.reshape(-1, ref.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float(np.max(np.linalg.norm(p - r, axis=1)
                        / np.maximum(np.linalg.norm(r, axis=1), 1e-30)))


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def mla():
    """(jax cfg, port cfg, jax layer-0 attention params, port's, jax model,
    jax params, port model, port params): the fp32 minicpm3 smoke model."""
    jcfg = dataclasses.replace(jax_smoke_config("minicpm3-4b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("minicpm3-4b"), dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    jl0 = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    return (jcfg, tcfg, jl0, tparams["layers"][0]["attn"], jmodel, jparams,
            build_model(tcfg), tparams)


def test_mla_params_shapes(mla):
    _, tcfg, _, tp, *_ = mla
    p = attention.mla_params(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, CPU)
    assert set(p) == set(tp) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    for name, w in p.items():
        assert w.shape == tp[name].shape, name
    assert p["q_norm"].dtype == torch.float32 and p["wq_b"].dtype == torch.bfloat16
    # wq_b: 4 heads x (16 nope + 8 rope); wkv_a: the 16-wide latent + the shared rope key
    assert tuple(p["wq_b"].shape) == (32, 96) and tuple(p["wkv_a"].shape) == (64, 24)


@pytest.mark.parametrize("seq, probs, tol", [
    (64, "fp32", TOL), (16, "fp32", TOL),
    # bf16 probabilities: a 1e-7 difference in a softmax value can round it
    # to the neighbouring bf16 value on one side only
    (64, "bf16", 2e-2)])
def test_expanded_path_matches_reference(mla, monkeypatch, seq, probs, tol):
    """Uncached: S = 64 > attn_chunk = 32 runs the chunk loop; wkv_b goes
    through ``linear`` (5 products a layer: wq_a, wq_b, wkv_a, wkv_b, wo)."""
    jcfg, tcfg, jp, tp, *_ = mla
    jcfg, tcfg = (dataclasses.replace(c, attn_probs_dtype=probs) for c in (jcfg, tcfg))
    x = _np(0, 2, seq, 64)
    pos = np.arange(seq)
    ref, _ = jattn.mla_attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    calls = []
    real = attention.linear
    monkeypatch.setattr(attention, "linear",
                        lambda a, w: calls.append(tuple(w.shape)) or real(a, w))
    out, cache = attention.mla_attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    assert cache is None
    assert row_rel(out, ref) < tol
    assert calls == [(64, 32), (32, 96), (64, 24), (16, 128), (64, 64)]


@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("tensor_slot", [False, True])
def test_absorbed_path_prefill_then_decode(mla, with_offsets, tensor_slot):
    """Prefill 8 slots of a 16-slot latent cache, then 3 decode steps with
    the slot an int or a 0-d tensor; outputs and the latent cache (written in
    place on the port side) agree.  With offsets, rows are left-padded by 0
    and 3 slots."""
    jcfg, tcfg, jp, tp, *_ = mla
    b, s, slots = 2, 8, 16
    off = np.array([0, 3]) if with_offsets else None
    jcache = jattn.mla_cache(jcfg, b, slots, jnp.float32)
    tcache = attention.mla_cache(tcfg, b, slots, torch.float32, CPU)
    assert tuple(tcache["c_kv"].shape) == jcache["c_kv"].shape == (2, 16, 16)
    assert tuple(tcache["k_rope"].shape) == jcache["k_rope"].shape == (2, 16, 8)
    jo = None if off is None else jnp.asarray(off)
    to = None if off is None else torch.from_numpy(off)
    slot = (lambda t: torch.tensor(t)) if tensor_slot else (lambda t: t)
    pos = np.arange(s) if off is None else np.arange(s)[None, :] - off[:, None]
    x = _np(1, b, s, 64)
    ref, jcache = jattn.mla_attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), jcache,
                                      jnp.int32(0), offsets=jo)
    out, tcache = attention.mla_attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                                          tcache, slot(0), offsets=to)
    assert row_rel(out, ref) < TOL
    for t in range(s, s + 3):
        xt = _np(10 + t, b, 1, 64)
        qpos = np.full((1,), t) if off is None else t - off[:, None]
        ref, jcache = jattn.mla_attention(jp, jnp.asarray(xt), jcfg, jnp.asarray(qpos),
                                          jcache, jnp.int32(t), offsets=jo)
        out, tcache = attention.mla_attention(tp, torch.from_numpy(xt), tcfg,
                                              torch.from_numpy(qpos), tcache, slot(t),
                                              offsets=to)
        assert row_rel(out, ref) < TOL
    for name in ("c_kv", "k_rope"):
        assert row_rel(tcache[name], jcache[name]) < TOL


def test_absorbed_prefill_equals_expanded_forward(mla):
    """The two paths compute the same attention: a cached prefill over the
    whole prompt gives the uncached path's output (as in the reference, to
    fp32 rounding)."""
    _, tcfg, _, tp, *_ = mla
    x = torch.from_numpy(_np(2, 2, 12, 64))
    pos = torch.arange(12)
    expanded, _ = attention.mla_attention(tp, x, tcfg, pos)
    cache = attention.mla_cache(tcfg, 2, 12, torch.float32, CPU)
    absorbed, _ = attention.mla_attention(tp, x, tcfg, pos, cache, 0)
    assert row_rel(absorbed, expanded.numpy()) < TOL


def test_a_latent_write_past_the_end_raises_as_gqa_does(mla):
    """An int slot past the end raises for the latent cache, in the layer and
    in the model's host check, as for a GQA cache."""
    _, tcfg, _, tp, *_, tmodel, tparams = mla
    cache = attention.mla_cache(tcfg, 1, 8, torch.float32, CPU)
    x = torch.from_numpy(_np(3, 1, 4, 64))
    with pytest.raises(ValueError, match="overruns"):
        attention.mla_attention(tp, x, tcfg, torch.arange(6, 10), cache, 6)
    with pytest.raises(ValueError, match="overruns"):
        attention.check_cache_write(tcfg, cache, 8, 1)
    attention.check_cache_write(tcfg, cache, 7, 1)
    # a window on an MLA config does not make its latent cache rolling
    windowed = dataclasses.replace(tcfg, window=8)
    with pytest.raises(ValueError, match="overruns"):
        attention.check_cache_write(windowed, cache, 8, 1)
    attention.check_cache_write(windowed, cache, 0, 8)
    mcache = tmodel.init_cache(1, 4, CPU)
    assert set(mcache["layers"][0]) == {"c_kv", "k_rope"}
    with pytest.raises(ValueError, match="overruns"):
        tmodel.check_decode_pos(mcache, 4)
    with pytest.raises(ValueError, match="overruns"):
        tmodel.decode_step(tparams, mcache, torch.ones(1, 1, dtype=torch.long), 4)
    tmodel.check_decode_pos(mcache, 3)


def test_model_tensor_slot_decode_is_bitwise_the_int_path(mla):
    """The MLA model decoded with the slot an int and as a 0-d tensor: the
    same logits and latent caches, bit for bit."""
    *_, tmodel, tparams = mla
    tokens = np.random.default_rng(4).integers(0, 256, size=(2, 12))
    off = torch.tensor([0, 3])
    caches = [tmodel.init_cache(2, 16, CPU) for _ in range(2)]
    with torch.no_grad():
        for c in caches:
            tmodel.prefill(tparams, c, torch.from_numpy(tokens[:, :4]), off)
        for t in range(4, 12):
            step = torch.from_numpy(tokens[:, t:t + 1])
            a, _ = tmodel.decode_step(tparams, caches[0], step, t, off)
            b, _ = tmodel.decode_step(tparams, caches[1], step, torch.tensor(t), off)
            assert torch.equal(a, b)
    for la, lb in zip(caches[0]["layers"], caches[1]["layers"]):
        assert torch.equal(la["c_kv"], lb["c_kv"]) and torch.equal(la["k_rope"], lb["k_rope"])
