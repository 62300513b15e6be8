"""The port's layers against the JAX package's, on the CPU, in fp32.

Parameters are the JAX smoke model's, passed through ``params_from_jax``;
activations come from a seeded numpy generator.  Tolerance: 1e-5 of the
output's largest magnitude (both sides compute in fp32; only the order of
sums differs).  At the end, the decode route of ``chunked_attention`` (one
query on the card -> ``kernels.decode_attention``): which calls take it, the
op's CPU implementation, its fake implementation, the cost counter's price
and the kernel's chunk plan, on the CPU without JAX.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.layers import attention as jattn
from repro.layers import embed as jembed
from repro.layers.mlp import mlp as jax_mlp
from repro.layers.norms import rms_norm as jax_rms_norm
from repro.layers.rope import apply_rope as jax_apply_rope
from repro.models.registry import build_model as jax_build_model
from repro_torch.checkpoint import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import decode_attention
from repro_torch.layers import attention, embed
from repro_torch.models.registry import build_model
from repro_torch.layers.mlp import mlp
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rope import apply_rope
from repro_torch.roofline import hlo_stats

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


def _embed_pair(tie, dtype, vocab=300, d=64):
    """The reference's embedding params in ``dtype`` and the port's copy."""
    jp = jembed.embed_params(jax.random.PRNGKey(3), vocab, d, tie, jnp.dtype(dtype))
    return jp, {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in jp.items()}


def _activations(seed, dtype, *shape):
    """The same values for both packages, rounded to ``dtype`` once."""
    x = jnp.asarray(_np(seed, *shape), jnp.dtype(dtype))
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))


# bf16: the reference's compute types, bf16 operands into fp32 logits (the
# products are exact in fp32 on both sides; only the order of sums differs)
@pytest.mark.parametrize("tie,dtype", [(True, "float32"), (False, "float32"),
                                       (True, "bfloat16"), (False, "bfloat16")],
                         ids=["True", "False", "True-bf16", "False-bf16"])
def test_embed_unembed_masks_padded_vocab(tie, dtype):
    vocab, d = 300, 64                          # pads to 512 columns
    jp, tp = _embed_pair(tie, dtype, vocab, d)
    tokens = np.random.default_rng(4).integers(0, vocab, size=(2, 7))
    _close(embed.embed(tp, torch.from_numpy(tokens)),
           jembed.embed(jp, jnp.asarray(tokens)).astype(jnp.float32))
    x, tx = _activations(5, dtype, 2, 7, d)
    ref = np.asarray(jembed.unembed(jp, x, vocab))
    out = embed.unembed(tp, tx, vocab)
    assert out.shape == (2, 7, 512) and out.dtype == torch.float32
    assert torch.all(out[..., vocab:] == -1e30) and np.all(ref[..., vocab:] == -1e30)
    _close(out[..., :vocab], ref[..., :vocab])


class _OpNames(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the name of every operator dispatched in its scope."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("tie", [True, False])
def test_unembed_reads_the_head_in_place_through_k1(tie, monkeypatch):
    """One K1 call (``ops._run``, the kernel on the card) on the folded
    rows and the head's own storage, the tied table through its ``.t()``
    view, fp32 out; no cast of either operand and no other product."""
    from repro_torch.kernels.matmul import ops

    _, tp = _embed_pair(tie, "bfloat16")
    _, tx = _activations(5, "bfloat16", 2, 7, 64)
    seen = []
    run = ops._run
    monkeypatch.setattr(ops, "_run", lambda a, b, blocks, order, out_dtype: seen.append(
        (a, b, out_dtype)) or run(a, b, blocks, order, out_dtype))
    with _OpNames() as mode:
        out = embed.unembed(tp, tx, 300)
    (a, b, out_dtype), = seen
    head = tp["embedding"] if tie else tp["lm_head"]
    assert a.shape == (14, 64) and b.shape == (64, 512) and out_dtype == torch.float32
    assert b.data_ptr() == head.data_ptr() and b.dtype == torch.bfloat16
    assert b.is_contiguous() != tie
    assert "repro_torch.zorder_matmul.default" in mode.names
    assert not any(n.startswith(("aten._to_copy", "aten.mm", "aten.bmm", "aten.addmm",
                                 "aten.clone")) for n in mode.names), mode.names
    assert out.shape == (2, 7, 512)


def _within_one_bf16_ulp(port: torch.Tensor, ref) -> None:
    """|port - ref| is at most one bf16 ulp of the larger of the two, or of
    2^-12 of the tensor's largest magnitude where both are smaller: an
    fp32 sum taken in another order moves by about 2^-24 of its terms'
    size, which for an element the terms nearly cancel in is more than its
    own bf16 ulp."""
    got = port.float().numpy().astype(np.float64)
    want = np.asarray(ref.astype(jnp.float32), np.float64)
    assert got.shape == want.shape
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -12 * np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) - ulp)


@pytest.mark.parametrize("tie", [True, False])
def test_unembed_backward_in_bf16_matches_jax_grad_within_one_ulp(tie, monkeypatch):
    """bf16 operands, fp32 logits and an fp32 cotangent: the reference's
    XLA products (fp32 accumulation, one rounding to bf16); the port's
    backward runs no K1 product (``ops._run`` is called by the forward
    only)."""
    from repro_torch.kernels.matmul import ops

    vocab = 300
    jp, tp = _embed_pair(tie, "bfloat16", vocab)
    x, tx = _activations(5, "bfloat16", 2, 7, 64)
    ct = _np(6, 2, 7, 512)
    _, vjp = jax.vjp(lambda p, h: jembed.unembed(p, h, vocab), jp, x)
    gp, gx = vjp(jnp.asarray(ct))
    calls = []
    run = ops._run
    monkeypatch.setattr(ops, "_run", lambda *a: calls.append(1) or run(*a))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx.requires_grad_(True)
    embed.unembed(tp, tx, vocab).backward(torch.from_numpy(ct))
    assert len(calls) == 1
    head = "embedding" if tie else "lm_head"
    for got, want in ((tx.grad, gx), (tp[head].grad, gp[head])):
        assert got.dtype == torch.bfloat16
        _within_one_bf16_ulp(got, want)
    assert tie or tp["embedding"].grad is None     # untied, the table is not read


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


# -- the cache slot as a device tensor ---------------------------------------------


@pytest.fixture(scope="module")
def llama_models():
    """(jax model, jax params, port model, port params): the fp32 Llama smoke model."""
    jcfg = dataclasses.replace(jax_smoke_config("llama3_2_1b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def _decode_both_ways(tmodel, tparams, tokens, offsets, max_seq):
    """Prefill 1 token, then decode the rest twice: with the slot as an int
    and as a 0-d int64 tensor; every step's logits and the caches."""
    b, s = tokens.shape
    caches = [tmodel.init_cache(b, max_seq, CPU) for _ in range(2)]
    off = None if offsets is None else torch.from_numpy(offsets)
    first = [tmodel.prefill(tparams, c, torch.from_numpy(tokens[:, :1]), off)[0] for c in caches]
    assert torch.equal(*first)
    steps = []
    for t in range(1, s):
        step = torch.from_numpy(tokens[:, t:t + 1])
        by_int, _ = tmodel.decode_step(tparams, caches[0], step, t, off)
        by_tensor, _ = tmodel.decode_step(tparams, caches[1], step,
                                          torch.tensor(t, dtype=torch.int64), off)
        steps.append((by_int, by_tensor))
    return steps, caches


@pytest.mark.parametrize("which", ["llama", "danube"])
@pytest.mark.parametrize("with_offsets", [False, True])
def test_tensor_slot_decode_is_bitwise_the_int_path(llama_models, danube_models, which,
                                                   with_offsets):
    """The same logits and caches, bit for bit, with the slot an int or a
    device tensor; danube's 16-slot window cache rolls 7 steps past the wrap."""
    _, _, tmodel, tparams = llama_models if which == "llama" else danube_models
    tokens = np.random.default_rng(12).integers(0, 256, size=(2, 24))
    offsets = np.array([0, 3], np.int64) if with_offsets else None
    steps, (c_int, c_tensor) = _decode_both_ways(tmodel, tparams, tokens, offsets, 32)
    for by_int, by_tensor in steps:
        assert torch.equal(by_int, by_tensor)
    for li, lt in zip(c_int["layers"], c_tensor["layers"]):
        assert torch.equal(li["k"], lt["k"]) and torch.equal(li["v"], lt["v"])


@pytest.mark.parametrize("which", ["llama", "danube"])
def test_tensor_slot_decode_matches_the_reference(llama_models, danube_models, which):
    """The tensor-slot decode against the reference's ``decode_step`` with a
    traced slot, for the same weights (``params_from_jax``), within 1e-5."""
    jmodel, jparams, tmodel, tparams = llama_models if which == "llama" else danube_models
    tokens = np.random.default_rng(13).integers(0, 256, size=(2, 20))
    jcache = jmodel.init_cache(2, 32)
    tcache = tmodel.init_cache(2, 32, CPU)
    ref, jcache = jmodel.prefill(jparams, jcache, jnp.asarray(tokens[:, :1]))
    out, tcache = tmodel.prefill(tparams, tcache, torch.from_numpy(tokens[:, :1]))
    _close(out, ref)
    decode = jax.jit(jmodel.decode_step)
    for t in range(1, 20):
        step = tokens[:, t:t + 1]
        ref, jcache = decode(jparams, jcache, jnp.asarray(step), jnp.int32(t))
        out, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(step),
                                         torch.tensor(t))
        _close(out, ref)


def test_the_int_slots_raises_stay_and_the_host_check_raises_for_a_tensor_slot(
        llama_models, danube_models):
    _, _, lmodel, lparams = llama_models
    cache = lmodel.init_cache(1, 4, CPU)
    one = torch.ones(1, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="overruns"):
        lmodel.decode_step(lparams, cache, one, 4)
    with pytest.raises(ValueError, match="overruns"):
        lmodel.check_decode_pos(cache, 4)
    lmodel.check_decode_pos(cache, 3)
    _, _, dmodel, dparams = danube_models
    rolling = dmodel.init_cache(1, 32, CPU)
    eight = torch.from_numpy(np.random.default_rng(14).integers(0, 256, size=(1, 8)))
    with pytest.raises(ValueError, match="rolling"):
        dmodel.prefill(dparams, rolling, eight)
    cfg = dmodel.cfg
    x = torch.from_numpy(_np(15, 1, 8, cfg.d_model))
    layer = dparams["layers"][0]["attn"]
    with pytest.raises(ValueError, match="rolling"):
        attention.gqa_attention(layer, x, cfg, torch.arange(8), rolling["layers"][0],
                                torch.tensor(0))
    dmodel.check_decode_pos(rolling, 1000)      # a rolling cache takes any slot


# -- the zoo's blocks: attn_moe, and MLA inside either kind --------------------------


@pytest.mark.parametrize("arch, stack, kind", [
    ("deepseek-moe-16b", "dense_layers", "attn_mlp"), ("deepseek-moe-16b", "layers", "attn_moe"),
    ("qwen3-moe-30b-a3b", "layers", "attn_moe"), ("minicpm3-4b", "layers", "attn_mlp")])
@pytest.mark.parametrize("cached", [False, True])
def test_zoo_block_matches_reference(arch, stack, kind, cached):
    """One block of each new kind and attention, uncached (S = 64) and as a
    cached prefill of 8 left-padded tokens: (x, aux) against the reference's
    ``block_apply`` within 1e-5 (aux 1e-6)."""
    from repro.layers.blocks import block_apply as jax_block_apply
    from repro_torch.layers.blocks import block_apply

    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams[stack])
    tp = tparams[stack][0]
    if not cached:
        x, pos = _np(30, 2, 64, 64), np.arange(64)
        ref, ref_aux, _ = jax_block_apply(jp, jnp.asarray(x), jcfg, kind, jnp.asarray(pos))
        out, aux, cache = block_apply(tp, torch.from_numpy(x), tcfg, kind, torch.from_numpy(pos))
        assert cache is None
    else:
        off = np.array([0, 3])
        x, pos = _np(31, 2, 8, 64), np.arange(8)[None, :] - off[:, None]
        jc = jax.tree.map(lambda a: a[0], jmodel.init_cache(2, 16)[stack])
        tc = tmodel.init_cache(2, 16, CPU)[stack][0]
        ref, ref_aux, _ = jax_block_apply(jp, jnp.asarray(x), jcfg, kind, jnp.asarray(pos), jc,
                                          jnp.int32(0), jnp.asarray(off))
        out, aux, _ = block_apply(tp, torch.from_numpy(x), tcfg, kind, torch.from_numpy(pos), tc,
                                  0, torch.from_numpy(off))
    _close(out, ref)
    assert abs(float(aux) - float(ref_aux)) < 1e-6
    assert (float(aux) > 0) == (kind == "attn_moe")


def test_block_kinds_not_yet_ported_raise():
    """Every block kind of the reference is ported (the recurrent ones
    build); a kind the reference does not have raises, as there, and so
    does an attention type no config uses."""
    from repro_torch.layers.blocks import KINDS, block_params

    assert KINDS == ("attn_mlp", "attn_moe", "mamba", "mlstm", "slstm")
    zcfg = get_smoke_config("zamba2-2.7b")
    assert set(block_params(torch.Generator().manual_seed(0), zcfg, "mamba", torch.float32,
                            CPU)) == {"norm", "mamba"}
    cfg = get_smoke_config("deepseek-moe-16b")
    with pytest.raises(ValueError, match="unknown block kind 'enc_attn_mlp'"):
        block_params(torch.Generator().manual_seed(0), cfg, "enc_attn_mlp", torch.float32, CPU)
    with pytest.raises(NotImplementedError, match="attention 'none'"):
        build_model(dataclasses.replace(cfg, attn_type="none"))


# -- the three configs that fill one card, at their published attention widths ---------


def _row_rel(port, ref) -> float:
    """Worst row's relative L2 error, rows along the last dim."""
    p = port.detach().float().numpy().reshape(-1, port.shape[-1])
    r = np.asarray(ref, np.float32).reshape(-1, p.shape[-1])
    return float(np.max(np.linalg.norm(p - r, axis=1)
                        / np.maximum(np.linalg.norm(r, axis=1), 1e-30)))


@pytest.mark.parametrize("arch, over", [
    ("granite-20b", dict(num_layers=2, d_ff=256, vocab_size=512)),
    ("chameleon-34b", dict(num_layers=1, d_ff=256, vocab_size=512)),
    ("qwen3-moe-30b-a3b", dict(num_layers=2, d_ff=64, moe_d_ff=64, vocab_size=512))])
def test_published_widths_prefill_and_decode_match_reference(arch, over):
    """granite-20b (d_model 6144, MQA 48/1), chameleon-34b (8192, GQA 64/8)
    and qwen3-moe-30b-a3b (2048, GQA 32/4, 128 experts top-8) at their
    published d_model, heads, K/V heads and head dim, fp32, with depth, the
    MLP widths and the vocabulary narrowed (under 1 GB a side): the weights
    carried over by ``params_from_jax``, a prefill of a left-padded batch
    and 3 decode steps at tensor slots, last-token logits per row within
    1e-5 of the reference's."""
    jcfg = dataclasses.replace(jax_get_config(arch), dtype="float32", **over)
    tcfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
    assert (tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim,
            tcfg.num_experts, tcfg.top_k) == {
        "granite-20b": (6144, 48, 1, 128, 0, 0), "chameleon-34b": (8192, 64, 8, 128, 0, 0),
        "qwen3-moe-30b-a3b": (2048, 32, 4, 128, 128, 8)}[arch]
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    v = tcfg.vocab_size
    batch = np.random.default_rng(40).integers(1, v, size=(2, 8))
    off = np.array([0, 3])
    batch[1, :3] = 0
    jcache, tcache = jmodel.init_cache(2, 16), tmodel.init_cache(2, 16, CPU)
    jo, to = jnp.asarray(off, jnp.int32), torch.from_numpy(off)
    ref, jcache = jmodel.prefill(jparams, jcache, jnp.asarray(batch), jo)
    with torch.no_grad():
        out, tcache = tmodel.prefill(tparams, tcache, torch.from_numpy(batch), to)
    assert _row_rel(out[:, :v], np.asarray(ref)[:, :v]) < TOL
    cur = np.argmax(np.asarray(ref)[:, :v], axis=-1)
    for t in range(8, 11):
        ref, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(cur[:, None]),
                                         jnp.int32(t), jo)
        with torch.no_grad():
            out, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(cur[:, None]),
                                             torch.tensor(t), to)
        assert _row_rel(out[:, :v], np.asarray(ref)[:, :v]) < TOL
        cur = np.argmax(np.asarray(ref)[:, :v], axis=-1)


# -- the decode route: one query on the card -> kernels.decode_attention ----------------

# (overrides of a bf16 one-query call on the card, the route it takes)
DECODE_ROUTES = {
    "one query on the card": ({}, "kernel"),
    "non-causal one query": ({"causal": False}, "kernel"),
    "two queries": ({"sq": 2}, "plain"),
    "bf16 probabilities": ({"probs": torch.bfloat16}, "plain"),
    "CPU tensors": ({"device": "cpu"}, "plain"),
    "fp32 tensors": ({"dtype": torch.float32}, "plain"),
    "head dim 12": ({"d": 12}, "plain"),
    "head dim 264": ({"d": 264}, "plain"),
}


@pytest.mark.parametrize("case", list(DECODE_ROUTES))
def test_chunked_attention_sends_one_query_on_the_card_to_the_decode_kernel(monkeypatch, case):
    """The route is chosen from the tensors alone: a patched launcher and a
    patched ``_sdpa`` record which one a call reaches, on fake tensors (no
    card needed).  An operand that requires grad is checked on the card
    (``tests/test_torch_cuda.py``): a CPU-only build of PyTorch cannot make
    a fake CUDA tensor that requires grad."""
    kw, want = DECODE_ROUTES[case]
    calls = []

    def record(name):
        def run(q, k, v, *args):
            calls.append(name)
            return v.new_empty((*q.shape[:-1], v.shape[-1]))
        return run

    monkeypatch.setattr(decode_attention, "decode_attention", record("kernel"))
    monkeypatch.setattr(attention, "_sdpa", record("plain"))
    b, s, hkv, g = 2, 24, 2, 4
    sq, d, dev = kw.get("sq", 1), kw.get("d", 16), kw.get("device", "cuda")
    dtype = kw.get("dtype", torch.bfloat16)
    with FakeTensorMode():
        q = torch.empty(b, sq, hkv * g, d, dtype=dtype, device=dev)
        k = torch.empty(b, s, hkv, d, dtype=dtype, device=dev)
        qpos = torch.empty(b, sq, dtype=torch.int64, device=dev)
        kpos = torch.empty(b, s, dtype=torch.int64, device=dev)
        out = attention.chunked_attention(q, k, k, qpos, kpos, causal=kw.get("causal", True),
                                          probs_dtype=kw.get("probs", torch.float32))
    assert calls == [want] and out.shape == (b, sq, hkv * g, d)


def _decode_case(mask, b=3, s=20, hkv=2, g=4, dk=16, dv=16):
    """bf16 CPU operands and (qpos, kpos, window, causal) as the callers
    make them (see ``tests/test_torch_cuda.py``'s decode tests)."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
               for shape in ((b, 1, hkv, g, dk), (b, s, hkv, dk), (b, s, hkv, dv)))
    idx = torch.arange(s)
    offsets = torch.tensor([0, 5, s - 1])[:b]
    if mask == "rolling":
        pos = torch.tensor(2 * s + 3)
        return q, k, v, pos.reshape(1), pos - torch.remainder(pos - idx, s), s, True
    if mask == "cross":
        return q, k, v, torch.arange(1), idx, 0, False
    pos = s - 1 if mask in ("offsets", "dk != dv") else 4     # row 3 sees no key at pos 4
    return q, k, v, pos - offsets[:, None], idx[None, :] - offsets[:, None], 0, True


DECODE_MASKS = {"offsets": {}, "rolling": {}, "cross": {}, "no valid key": {},
                "dk != dv": {"dk": 24, "dv": 16}}


@pytest.mark.parametrize("mask", list(DECODE_MASKS))
def test_the_decode_op_on_the_cpu_is_sdpa_to_the_bit(mask):
    """The op's CPU implementation, reached through the dispatcher and
    through ``decode_attention``, is the plain version: ``_sdpa`` with fp32
    probabilities, bit for bit."""
    q, k, v, qpos, kpos, window, causal = _decode_case(mask, **DECODE_MASKS[mask])
    want = attention._sdpa(q, k, v, qpos, kpos, window, 0.3, causal, torch.float32)
    got = torch.ops.repro_torch.decode_attention(q, k, v, qpos, kpos, window, 0.3, causal)
    again = decode_attention.decode_attention(q, k, v, qpos, kpos, window, 0.3, causal)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert want.shape == (3, 1, 2, 4, v.shape[-1]) and want.dtype == torch.bfloat16
    if mask == "no valid key":
        assert torch.allclose(want[-1, 0].float(),
                              v[-1].float().mean(0)[:, None, :].expand(2, 4, 16), atol=1e-2)


def test_the_decode_ops_fake_implementation_gives_the_shape_and_type():
    with FakeTensorMode():
        q = torch.empty(2, 1, 2, 3, 24, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 40, 2, 24, dtype=torch.bfloat16, device="cuda")
        v = torch.empty(2, 40, 2, 16, dtype=torch.bfloat16, device="cuda")
        qpos = torch.empty(2, 1, dtype=torch.int64, device="cuda")
        kpos = torch.empty(2, 40, dtype=torch.int64, device="cuda")
        out = torch.ops.repro_torch.decode_attention(q, k, v, qpos, kpos, 0, 0.2, True)
    assert out.shape == (2, 1, 2, 3, 16) and out.dtype == torch.bfloat16
    assert out.device.type == "cuda"


@pytest.mark.parametrize("arch", ["llama3_2_1b", "granite_20b", "h2o_danube3_4b",
                                  "chameleon_34b", "qwen3_moe_30b_a3b", "deepseek_moe_16b",
                                  "zamba2_2_7b", "seamless_m4t_medium", "minicpm3_4b"])
def test_every_familys_one_query_calls_give_views_the_decode_kernel_reads(monkeypatch, arch):
    """The decode kernel raises on a view its 16-byte loads cannot read
    (``kernel.aligned``), so every one-query call a bf16 smoke model makes
    in a teacher-forced prefill and a decode step (seamless after
    ``prefill_cross``; the cross-attention too; danube's rolling window
    cache) must give aligned views.
    ``takes`` is asked of stand-ins on the card, and the launcher records
    each call's views and runs the plain version; MLA's cached path makes
    no such call."""
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.runtime.serve import prefill

    seen = []

    def record(q, k, v, qpos, kpos, window, scale, causal):
        seen.append(kernel.aligned(q, k, v))
        return decode_attention.plain(q, k, v, qpos, kpos, window, scale, causal)

    takes = decode_attention.takes
    monkeypatch.setattr(decode_attention, "takes", lambda q, k, v: takes(*(
        SimpleNamespace(device=torch.device("cuda"), dtype=t.dtype, shape=t.shape,
                        requires_grad=t.requires_grad) for t in (q, k, v))))
    monkeypatch.setattr(decode_attention, "decode_attention", record)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.ones((2, 8), dtype=torch.int64)
    with torch.no_grad():
        if cfg.family == "audio":
            src = torch.zeros((2, 32, cfg.d_model), dtype=torch.bfloat16)
            cache = model.prefill_cross(params, model.encode(params, src),
                                        model.init_cache(2, 16, "cpu", src_len=32))
        else:
            cache = model.init_cache(2, 32, "cpu")
        if cfg.window:                  # a rolling cache of the window's slots, a token a step
            for pos in (0, 8, cfg.window + 3):
                model.decode_step(params, cache, tokens[:, -1:], torch.tensor(pos))
        else:
            prefill(model, params, cache, tokens)
            model.decode_step(params, cache, tokens[:, -1:], torch.tensor(8))
    assert cfg.dtype == "bfloat16" and all(seen)
    assert bool(seen) == (cfg.attn_type != "mla")


# each mask kind's (valid slots over the case's 3 rows, rows with no valid key)
DECODE_VALID = {"offsets": (20 + 15 + 1, 0), "rolling": (3 * 20, 0), "cross": (3 * 20, 0),
                "no valid key": (5, 2)}


def _decode_price(slots, empty, b=3, s=20, hkv=2, g=4, dk=16, dv=16):
    """``hlo_stats.decode_cost`` by hand: 2 (Dk + Dv) flops per valid slot
    and query head; bf16 Q and O once, K and V of the valid slots, V whole
    for a row with no valid key."""
    return (2.0 * (dk + dv) * hkv * g * slots,
            2.0 * (b * hkv * g * (dk + dv) + hkv * (slots * (dk + dv) + empty * s * dv)))


@pytest.mark.parametrize("mask", list(DECODE_VALID))
def test_the_cost_counter_prices_the_decode_op_by_its_valid_slots(mask):
    """Under the cost counter ``decode_attention`` is one op,
    ``repro_torch::decode_attention``, priced as the kernel works: the
    valid slots of each row, counted here by hand from the case's
    positions; the plain version's einsums and fp32 casts are not seen.
    On fake tensors (the dry run) every slot is priced."""
    q, k, v, qpos, kpos, window, causal = _decode_case(mask)
    with hlo_stats.counting() as c:
        out = decode_attention.decode_attention(q, k, v, qpos, kpos, window, 0.3, causal)
    assert torch.equal(out, attention._sdpa(q, k, v, qpos, kpos, window, 0.3, causal))
    assert c.calls == {hlo_stats.D1_OP: 1}
    assert (c.cost().flops, c.cost().bytes) == _decode_price(*DECODE_VALID[mask])
    with FakeTensorMode() as fake:
        fq, fk, fv, fqpos, fkpos = (fake.from_tensor(t) for t in (q, k, v, qpos, kpos))
        with hlo_stats.counting() as c:
            decode_attention.decode_attention(fq, fk, fv, fqpos, fkpos, window, 0.3, causal)
    assert c.calls == {hlo_stats.D1_OP: 1}
    assert (c.cost().flops, c.cost().bytes) == _decode_price(3 * 20, 0)


# (B, H_kv, G, S): the serving cells, a small-batch decode, granite's 48 query
# heads over one K/V head, a long context, a cache shorter than any chunk
SPLIT_SHAPES = [(64, 8, 4, 850), (64, 16, 1, 850), (4, 8, 4, 64), (2, 1, 48, 300),
                (1, 8, 4, 32768), (1, 1, 1, 5)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_the_split_plan_covers_every_slot_in_chunks_the_kernel_takes(shape):
    """Chunks of 32-slot multiples from ``MIN_CHUNK`` to ``MAX_CHUNK`` (or
    all of a shorter cache) covering S, within ``MAX_SLOT_HEADS`` slots x
    query heads; as many blocks as ``BLOCKS_PER_SM`` asks for within one
    32-slot step of the chunk, unless the chunk is as short as it goes."""
    from repro_torch.kernels.decode_attention import kernel

    b, hkv, g, s = shape
    chunk, splits = kernel.split_plan(*shape, 132)
    assert 1 <= chunk <= min(s, kernel.MAX_CHUNK) and splits == -(-s // chunk)
    assert chunk == s or (chunk % 32 == 0 and chunk >= kernel.MIN_CHUNK)
    assert chunk * kernel.group_tile(g) <= kernel.MAX_SLOT_HEADS or chunk == kernel.MIN_CHUNK
    groups = b * hkv * -(-g // kernel.MAX_GROUP)
    assert (groups * -(-s // (chunk - 32)) >= kernel.BLOCKS_PER_SM * 132
            or chunk == min(s, kernel.MIN_CHUNK))
