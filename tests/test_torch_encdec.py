"""The port's encoder-decoder model (seamless-m4t-medium) against the JAX
package's, on the CPU.

Parameters are the JAX smoke model's (``params_from_jax``), frame
embeddings and tokens come from a seeded numpy generator.  Tolerances: in
fp32 each output row (the last dim) within 1e-5 relative L2 of the
reference's row (``TOL``); decode against ``decode_train`` in bf16 within
0.08 of the largest logit, as ``tests/test_models.py``; greedy tokens
exactly.  The encoder's flash route (``attn_impl="flash"``) runs K2's plain
version on the CPU and is held to the reference's chunked core.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import generate as jax_generate
from repro_torch.checkpoint import params_from_jax, params_to_jax, state_from_jax, state_to_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.config import port_only_defaults
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve import ServeConfig, batch_requests, generate
from repro_torch.serve import Server
from repro_torch.serve.server import PAD_ID

TOL = 1e-5
BF16_DECODE_TOL = 0.08
CPU = torch.device("cpu")
ARCH = "seamless-m4t-medium"
PROMPTS = [[5, 6, 7], [9, 2, 3, 4, 1], [17, 3], [8, 8, 8, 8, 8, 8, 1]]


def row_rel(port, ref) -> float:
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    p, r = port.reshape(-1, ref.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float(np.max(np.linalg.norm(p - r, axis=1)
                        / np.maximum(np.linalg.norm(r, axis=1), 1e-30)))


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _models(dtype: str = "float32", **over):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype, **over)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def test_config_is_the_references():
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        # the reference's fields, and the port's own at the defaults that keep them
        assert dataclasses.asdict(port) == {**dataclasses.asdict(ref), **port_only_defaults()}
    cfg = get_config(ARCH)
    assert (cfg.enc_layers, cfg.dec_layers, cfg.d_model, cfg.num_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (12, 12, 1024, 16, 64, 4096, 256206)
    model = build_model(cfg)
    assert type(model).__name__ == "EncDecLM"
    assert model.param_stacks() == [("enc_layers", 12), ("dec_layers", 12)]


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("src_len", [24, 64])
def test_encode_matches_reference(attn_impl, src_len):
    """The non-causal encoder against the reference's (chunked core, xla);
    the port's flash route (K2's plain version on the CPU) too.  S = 64 is
    two of the smoke config's 32-query chunks."""
    jmodel, jparams, _, _ = _models()
    _, _, tmodel, tparams = _models(attn_impl=attn_impl)
    src = _np(0, 2, src_len, 64)
    ref = jmodel.encode(jparams, jnp.asarray(src))
    with torch.no_grad():
        out = tmodel.encode(tparams, torch.from_numpy(src))
    assert out.shape == (2, src_len, 64) and out.dtype == torch.float32
    assert row_rel(out, ref) < TOL


def test_encoder_is_not_causal():
    """A change to the last frame moves the first position's output."""
    _, _, tmodel, tparams = _models()
    src = _np(1, 1, 16, 64)
    src2 = src.copy()
    src2[0, -1] += 1.0
    with torch.no_grad():
        a, b = (tmodel.encode(tparams, torch.from_numpy(s)) for s in (src, src2))
    assert (a[0, 0] - b[0, 0]).abs().max().item() > 1e-3


def test_forward_and_loss_match_reference():
    jmodel, jparams, tmodel, tparams = _models()
    v = tmodel.cfg.vocab_size
    rng = np.random.default_rng(2)
    batch = {"src_embed": _np(3, 2, 24, 64), "tokens": rng.integers(0, v, size=(2, 16)),
             "labels": rng.integers(0, v, size=(2, 16))}
    batch["labels"][1, :3] = -100
    ref, _ = jmodel.forward(jparams, {k: jnp.asarray(a) for k, a in batch.items()})
    ref_loss, _ = jmodel.loss(jparams, {k: jnp.asarray(a) for k, a in batch.items()})
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    with torch.no_grad():
        out, aux = tmodel.forward(tparams, tb)
        loss, _ = tmodel.loss(tparams, tb)
    assert out.shape == (2, 16, 256) and float(aux) == 0.0
    assert row_rel(out[..., :v], np.asarray(ref)[..., :v]) < TOL
    assert abs(float(loss) - float(ref_loss)) < 1e-5 * abs(float(ref_loss))


def test_encode_prefill_cross_and_decode_steps_match_reference():
    """The inference path: ``encode`` -> ``prefill_cross`` (in place, the
    cache sized to the source) -> 10 decode steps with the slot a 0-d
    tensor; each step's logits within ``TOL`` of the reference's, and of
    ``decode_train``'s over the same tokens."""
    jmodel, jparams, tmodel, tparams = _models()
    v = tmodel.cfg.vocab_size
    src = _np(4, 2, 24, 64)
    tokens = np.random.default_rng(5).integers(0, v, size=(2, 10))
    jmem = jmodel.encode(jparams, jnp.asarray(src))
    jc = jmodel.prefill_cross(jparams, jmem, jmodel.init_cache(2, 16, src_len=24))
    train = jmodel.decode_train(jparams, jmem, jnp.asarray(tokens))
    with torch.no_grad():
        tmem = tmodel.encode(tparams, torch.from_numpy(src))
        tc = tmodel.init_cache(2, 16, CPU, src_len=24)
        cross_k = tc["cross"][0]["k"]
        assert tmodel.prefill_cross(tparams, tmem, tc) is tc
        assert tc["cross"][0]["k"] is cross_k                       # written in place
        assert row_rel(tc["cross"][1]["v"], jc["cross"]["v"][1]) < TOL
        for t in range(10):
            ref, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tokens[:, t:t + 1]),
                                         jnp.int32(t))
            out, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tokens[:, t:t + 1]),
                                         torch.tensor(t))
            assert row_rel(out[:, :v], np.asarray(ref)[:, :v]) < TOL
            assert row_rel(out[:, :v], np.asarray(train)[:, t, :v]) < TOL


def test_prefill_cross_of_another_source_length_replaces_the_cache():
    """As the reference returns K/V of the memory's own length: a source of
    64 frames into a 24-frame cache replaces each layer's tensors."""
    _, _, tmodel, tparams = _models()
    with torch.no_grad():
        mem = tmodel.encode(tparams, torch.from_numpy(_np(6, 2, 64, 64)))
        tc = tmodel.prefill_cross(tparams, mem, tmodel.init_cache(2, 16, CPU, src_len=24))
    assert tuple(tc["cross"][1]["k"].shape) == (2, 64, 4, 16)


def test_decode_matches_decode_train_bf16():
    """bf16: the decode steps after ``prefill_cross`` against the uncached
    ``decode_train`` over the same tokens, within 0.08 of the largest
    logit."""
    _, _, tmodel, tparams = _models("bfloat16")
    v = tmodel.cfg.vocab_size
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, v, size=(2, 24)))
    with torch.no_grad():
        mem = tmodel.encode(tparams, torch.from_numpy(_np(8, 2, 20, 64)))
        fwd = tmodel.decode_train(tparams, mem, tokens)
        cache = tmodel.prefill_cross(tparams, mem, tmodel.init_cache(2, 24, CPU, src_len=20))
        errs = []
        for t in range(24):
            logits, cache = tmodel.decode_step(tparams, cache, tokens[:, t:t + 1], t)
            errs.append((logits[:, :v] - fwd[:, t, :v]).abs().max().item())
    assert max(errs) / fwd[..., :v].abs().max().item() < BF16_DECODE_TOL


def test_generate_tokens_match_reference():
    """``generate`` as the reference runs it for this model: teacher-forced
    prompt, then greedy steps, over ``init_cache``'s zero cross cache
    (``src_len`` 1024); the same tokens on a left-padded batch."""
    jmodel, jparams, tmodel, tparams = _models()
    batch, lens = batch_requests(PROMPTS)
    scfg = dict(max_new_tokens=8, max_seq=32)
    ref = jax_generate(jmodel, jparams, batch, JaxServeConfig(**scfg), lens=lens)
    out = generate(tmodel, tparams, batch, ServeConfig(**scfg), lens=lens)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_generate_ignores_the_source_as_the_reference_does():
    """The reference behaviour the port copies (``ROADMAP.md`` §3): over
    the zero cross cache the cross-attention adds 0 (uniform weights over
    zero values, through ``wo``), so scaling every cross-attention weight
    changes no token of ``generate``, on either package; the model's own
    path (``encode`` -> ``prefill_cross``) does read them."""
    jmodel, jparams, tmodel, tparams = _models()
    batch, lens = batch_requests(PROMPTS)
    scfg = ServeConfig(max_new_tokens=6, max_seq=32)
    scaled = {**tparams, "dec_layers": [
        {**lp, "cross_attn": {k: 3.0 * w for k, w in lp["cross_attn"].items()}}
        for lp in tparams["dec_layers"]]}
    jscaled = {**jparams, "dec_layers": {**jparams["dec_layers"], "cross_attn": jax.tree.map(
        lambda w: 3.0 * w, jparams["dec_layers"]["cross_attn"])}}
    jcfg = JaxServeConfig(max_new_tokens=6, max_seq=32)
    np.testing.assert_array_equal(generate(tmodel, tparams, batch, scfg, lens=lens),
                                  generate(tmodel, scaled, batch, scfg, lens=lens))
    np.testing.assert_array_equal(np.asarray(jax_generate(jmodel, jparams, batch, jcfg)),
                                  np.asarray(jax_generate(jmodel, jscaled, batch, jcfg)))
    with torch.no_grad():
        mem = tmodel.encode(tparams, torch.from_numpy(_np(9, 4, 24, 64)))
        logits = []
        for p in (tparams, scaled):
            cache = tmodel.prefill_cross(p, mem, tmodel.init_cache(4, 8, CPU, src_len=24))
            logits.append(tmodel.decode_step(p, cache, torch.ones(4, 1, dtype=torch.int64),
                                             0)[0])
    assert (logits[0] - logits[1]).abs().max().item() > 1e-2


def test_server_tokens_match_reference_generate():
    """``Server`` (bucket 4x16) against the reference's ``generate`` on the
    same bucket-padded batch."""
    jmodel, jparams, tmodel, tparams = _models()
    scfg = dict(max_new_tokens=5, max_seq=32)
    srv = Server(tmodel, tparams, ServeConfig(**scfg), buckets=[(4, 16)])
    srv.warmup()
    res = srv.generate(PROMPTS)
    batch, lens = batch_requests(PROMPTS, PAD_ID, pad_to=16)
    full = jax_generate(jmodel, jparams, batch, JaxServeConfig(**scfg), lens=lens)
    assert res.sequences == [full[i, 16 - int(lens[i]):].tolist() for i in range(4)]


def test_params_and_optimizer_state_cross_both_ways_bitwise():
    """``enc_layers`` / ``dec_layers`` stacked, ``enc_norm`` and the rest
    as they are, bf16 kept; AdamW state too."""
    from repro.optim import adamw as jax_adamw

    jmodel, jparams, _, _ = _models("bfloat16")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    back = params_to_jax(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, CPU))
    assert sorted(back) == ["dec_layers", "embed", "enc_layers", "enc_norm", "final_norm"]
    assert jax.tree.structure(jparams) == jax.tree.structure(
        jax.tree.map(lambda t: 0, back, is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back, is_leaf=torch.is_tensor)):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    jstate = jax_adamw.init(jparams)
    sback = state_to_jax(state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, CPU))
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(sback, is_leaf=torch.is_tensor)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_launcher_serves_the_smoke_model_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--max-new", "3",
                              "--buckets", "4x16"]) == 0
    out = capsys.readouterr().out
    assert "arch=seamless-m4t-smoke" in out and "bucket=4x16" in out
