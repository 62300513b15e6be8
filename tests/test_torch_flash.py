"""The port's flash attention (K2) and the long-prefill slice against the
JAX package's, on the CPU.

On the CPU the port's ``mha`` runs its plain version (the kernel needs the
card); the reference's ``mha`` runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it.  Inputs come from a seeded numpy
generator; bf16 inputs are the same fp32 numbers rounded to bf16 on both
sides.  Tolerances are the reference's own: 1e-4 absolute in fp32, 0.05 in
bf16 (the reference kernel keeps P in fp32; bf16 output rounding is
2^-8 relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import mha as jax_mha
from repro.models.registry import build_model as jax_build_model
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import attention_ref, kernel, mha
from repro_torch.layers import attention
from repro_torch.models.registry import build_model

TOL = {"float32": 1e-4, "bfloat16": 0.05}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, sq, skv, hq, hkv, d, dtype):
    """(jax q, k, v), (torch q, k, v) holding the same values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    return ([jnp.asarray(a, JNP[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs])


def _max_abs(port, ref):
    port = port.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.max(np.abs(port - ref)))


# (B, S_q, S_kv, H_q, H_kv, D, causal, window, dtype): the reference's cases
# in tests/test_kernels.py, then head dims 120 (danube), 80 (zamba2) and 128
# at S = 256 and 384; then the head layouts of granite-20b (MQA, 48 query
# heads over one K/V head), chameleon-34b (64/8) and qwen3-moe-30b-a3b
# (32/4), D 128, in fp32 and bf16.
MHA_CASES = [
    *[(2, 256, 256, hq, hkv, 32, True, 0, dt)
      for (hq, hkv) in ((4, 4), (4, 2), (8, 1)) for dt in ("float32", "bfloat16")],
    (1, 384, 384, 2, 2, 32, True, 64, "float32"),
    (1, 384, 384, 2, 2, 32, True, 200, "float32"),
    (1, 300, 512, 2, 2, 32, True, 0, "float32"),
    (1, 256, 256, 4, 2, 120, True, 0, "float32"),
    (1, 384, 384, 4, 2, 120, True, 200, "float32"),
    (1, 384, 384, 4, 1, 120, True, 0, "bfloat16"),
    (1, 256, 256, 4, 2, 80, True, 0, "float32"),
    (1, 384, 384, 4, 1, 80, True, 200, "bfloat16"),
    (1, 256, 256, 2, 2, 128, True, 0, "float32"),
    (1, 384, 384, 4, 1, 128, True, 200, "bfloat16"),
    *[(1, sq, sq, hq, hkv, 128, True, 0, dt)
      for (sq, hq, hkv) in ((256, 48, 1), (256, 64, 8), (384, 32, 4))
      for dt in ("float32", "bfloat16")],
]


@pytest.mark.parametrize("case", MHA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_mha_matches_reference_kernel(case):
    b, sq, skv, hq, hkv, d, causal, window, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(sum(case[:6]), b, sq, skv, hq, hkv, d, dtype)
    ref = jax_mha(jq, jk, jv, causal=causal, window=window, block_q=128,
                  block_kv=128, interpret=True)
    before = kernel.launches
    out = mha(tq, tk, tv, causal=causal, window=window)
    assert kernel.launches == before           # a CPU tensor takes the plain version
    assert out.dtype == TORCH[dtype] and out.shape == (b, sq, hq, d)
    assert _max_abs(out, ref) < TOL[dtype]


@pytest.mark.parametrize("causal, window, hq, hkv, sq, skv", [
    (True, 0, 4, 2, 64, 64), (False, 0, 4, 4, 48, 80), (True, 16, 6, 2, 70, 70),
    (False, 24, 2, 1, 40, 40), (True, 0, 2, 2, 50, 30)])
def test_attention_ref_matches_reference(causal, window, hq, hkv, sq, skv):
    """The plain versions agree on (BH, S, D): GQA by head // group, masks
    with and without the causal limit, S_q shorter and longer than S_kv."""
    rng = np.random.default_rng(sq + skv + hq)
    q = rng.standard_normal((2 * hq, sq, 16), dtype=np.float32)
    k = rng.standard_normal((2 * hkv, skv, 16), dtype=np.float32)
    v = rng.standard_normal((2 * hkv, skv, 16), dtype=np.float32)
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window)
    out = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal, window=window)
    assert _max_abs(out, ref) < 1e-5


def test_attention_ref_fully_masked_rows_output_zero():
    """Causal with window 1: row i sees key i only, so the rows past the
    last key (S_q > S_kv) see none and output 0 in both packages."""
    q = np.ones((1, 6, 4), np.float32)
    k = np.ones((1, 3, 4), np.float32)
    v = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    ref = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=True, window=1))
    out = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=True, window=1).numpy()
    assert np.all(ref[0, 3:] == 0) and np.all(out[0, 3:] == 0)
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("sq, skv, causal, raises", [
    (300, 600, False, True),     # padded keys, not causal: the reference refuses
    (300, 512, False, False),    # S_kv a multiple of its block: no padding
    (200, 600, False, False),    # S_q < 256: the reference takes its oracle
    (300, 600, True, False),     # causal: padded keys are masked
])
def test_noncausal_padded_kv_refused_in_both(sq, skv, causal, raises):
    (jq, jk, jv), (tq, tk, tv) = _inputs(0, 1, sq, skv, 1, 1, 16, "float32")
    for run in (lambda: jax_mha(jq, jk, jv, causal=causal, interpret=True),
                lambda: mha(tq, tk, tv, causal=causal)):
        if raises:
            with pytest.raises(NotImplementedError, match="non-causal padding"):
                run()
        else:
            assert np.all(np.isfinite(np.asarray(run(), np.float32)))


@pytest.fixture(scope="module")
def danube_pair():
    """(jax model, jax params, port model, port params): the fp32 danube
    smoke model, window 16, with ``attn_impl="flash"`` on the port side."""
    jcfg = dataclasses.replace(jax_smoke_config("h2o-danube-3-4b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("h2o-danube-3-4b"), dtype="float32",
                               attn_impl="flash")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def _rel_err(port, ref):
    port, ref = port.detach().float().numpy(), np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.max(np.abs(port - ref)) / (np.max(np.abs(ref)) + 1e-12))


@pytest.mark.parametrize("what", ["forward", "loss"])
def test_danube_smoke_flash_slice_matches_reference(danube_pair, what):
    """The whole slice on the CPU: the port's forward with the flash route
    (its plain version here, so no kernel launch) against the reference's
    chunked forward, at S = 64, four times the smoke window of 16; labels
    are the next tokens with the last one ignored.  1e-5 relative in fp32."""
    jmodel, jparams, tmodel, tparams = danube_pair
    tokens = np.random.default_rng(3).integers(0, 256, size=(2, 64))
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -100)], axis=1)
    before = kernel.launches
    if what == "forward":
        ref, _ = jmodel.forward(jparams, jnp.asarray(tokens))
        out, aux = tmodel.forward(tparams, torch.from_numpy(tokens))
        assert float(aux) == 0.0
        assert _rel_err(out, ref) < 1e-5
    else:
        ref, rparts = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens),
                                            "labels": jnp.asarray(labels)})
        out, parts = tmodel.loss(tparams, {"tokens": torch.from_numpy(tokens),
                                           "labels": torch.from_numpy(labels)})
        assert abs(float(out) - float(ref)) < 1e-5 * abs(float(ref))
        assert abs(float(parts["ce"]) - float(rparts["ce"])) < 1e-5 * abs(float(ref))
    assert kernel.launches == before


@pytest.mark.parametrize("bad", ["bf16_probs", "per_row_positions"])
def test_flash_route_refuses_what_the_kernel_cannot_do(danube_pair, bad):
    _, _, tmodel, tparams = danube_pair
    cfg = tmodel.cfg
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 8, 64),
                                                                  dtype=np.float32))
    positions = torch.arange(8)
    if bad == "bf16_probs":
        cfg = dataclasses.replace(cfg, attn_probs_dtype="bf16")
        match = "fp32"
    else:
        positions = positions[None, :].repeat(2, 1)
        match = "1-D positions"
    with pytest.raises(ValueError, match=match):
        attention.gqa_attention(tparams["layers"][0]["attn"], x, cfg, positions)
