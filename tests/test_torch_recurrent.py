"""The port's recurrent families against the JAX package's, on the CPU.

The Mamba-2, mLSTM and sLSTM layers, their blocks, and the zamba2-2.7b
(``HybridLM``) and xlstm-350m (``XLSTMLM``) smoke models.  Parameters are
the JAX smoke models' (``params_from_jax``), activations and tokens come
from a seeded numpy generator.  The reference computes these layers with
``jnp.einsum`` and ``lax.scan`` outside Pallas, so it runs as is.

Tolerances: in fp32 each output row (the last dim) within 1e-5 relative L2
of the reference's row (``TOL``); a recurrent state within 1e-5 relative
L2 as a whole; decode against the uncached forward in bf16 within 0.08 of
the largest logit, as ``tests/test_models.py::test_decode_matches_forward``;
greedy tokens exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.layers import blocks as jblocks
from repro.layers import mamba2 as jmamba2
from repro.layers import xlstm as jxlstm
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import generate as jax_generate
from repro_torch.checkpoint import params_from_jax, params_to_jax, state_from_jax, state_to_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.layers import blocks as tblocks
from repro_torch.layers import mamba2 as tmamba2
from repro_torch.layers import xlstm as txlstm
from repro_torch.models.config import port_only_defaults
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve import ServeConfig, batch_requests, generate, prefill
from repro_torch.serve import Server
from repro_torch.serve.server import DUMMY_TOKEN, PAD_ID

TOL = 1e-5
BF16_DECODE_TOL = 0.08
CPU = torch.device("cpu")
ARCHS = ("zamba2-2.7b", "xlstm-350m")
PROMPTS = [[5, 6, 7], [9, 2, 3, 4, 1], [17, 3], [8, 8, 8, 8, 8, 8, 1]]


def row_rel(port, ref) -> float:
    """Worst row's relative L2 error, rows along the last dim."""
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    p, r = port.reshape(-1, ref.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float(np.max(np.linalg.norm(p - r, axis=1)
                        / np.maximum(np.linalg.norm(r, axis=1), 1e-30)))


def state_rel(port, ref) -> float:
    port, ref = port.detach().double().numpy(), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30))


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str = "float32"):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    of the smoke model, the weights crossed by ``params_from_jax``."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


def _layer(arch: str, stack: str, kind: str, **over):
    """(jax cfg, port cfg, jax params, port params) of the first ``kind``
    layer of the smoke model's ``stack``, fp32, ``over`` replaced in both
    configs."""
    jcfg, _, jparams, tcfg, _, tparams = _models(arch)
    return (dataclasses.replace(jcfg, **over), dataclasses.replace(tcfg, **over),
            jax.tree.map(lambda a: a[0], jparams[stack][kind]), tparams[stack][0][kind])


LAYERS = {"mamba": ("zamba2-2.7b", "mamba_layers", jmamba2.mamba2, tmamba2.mamba2),
          "mlstm": ("xlstm-350m", "m_layers", jxlstm.mlstm, txlstm.mlstm),
          "slstm": ("xlstm-350m", "s_layers", jxlstm.slstm, txlstm.slstm)}


def _caches(kind: str, jcfg, tcfg, batch: int):
    if kind == "mamba":
        return (jmamba2.mamba2_cache(jcfg, batch, jnp.float32),
                tmamba2.mamba2_cache(tcfg, batch, torch.float32, CPU))
    if kind == "mlstm":
        return jxlstm.mlstm_cache(jcfg, batch), txlstm.mlstm_cache(tcfg, batch, CPU)
    return jxlstm.slstm_cache(jcfg, batch), txlstm.slstm_cache(tcfg, batch, CPU)


# -- layers -----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(LAYERS))
@pytest.mark.parametrize("batch, seq", [(2, 32), (2, 24), (3, 8), (1, 1)])
def test_layer_uncached_matches_reference(kind, batch, seq):
    """The smoke chunk is 16: two whole chunks at S = 32, a zero-padded
    second chunk at S = 24, one short chunk at S = 8 and S = 1."""
    arch, stack, jfn, tfn = LAYERS[kind]
    jcfg, tcfg, jp, tp = _layer(arch, stack, kind)
    x = _np(0, batch, seq, tcfg.d_model)
    ref, _ = jfn(jp, jnp.asarray(x), jcfg)
    out, cache = tfn(tp, torch.from_numpy(x), tcfg)
    assert cache is None and out.dtype == torch.float32
    assert row_rel(out, ref) < TOL


@pytest.mark.parametrize("kind", list(LAYERS))
def test_layer_decode_steps_match_reference(kind):
    """12 decode steps from the zero state, each output within ``TOL`` of
    the reference's step; the state, written in place, within ``TOL`` of
    the reference's new state after every step; and the steps' outputs
    within ``TOL`` of the uncached pass over the same 12 tokens."""
    arch, stack, jfn, tfn = LAYERS[kind]
    jcfg, tcfg, jp, tp = _layer(arch, stack, kind)
    x = _np(1, 2, 12, tcfg.d_model)
    jc, tc = _caches(kind, jcfg, tcfg, 2)
    leaves = {k: v for k, v in tc.items()}
    outs = []
    for t in range(12):
        ref, jc = jfn(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jc, jnp.int32(t))
        out, tc2 = tfn(tp, torch.from_numpy(x[:, t:t + 1]), tcfg, tc, torch.tensor(t))
        assert tc2 is tc and all(tc[k] is v for k, v in leaves.items())   # in place
        assert row_rel(out, ref) < TOL
        for key in jc:
            assert state_rel(tc[key], jc[key]) < TOL, (t, key)
        outs.append(out)
    full, _ = tfn(tp, torch.from_numpy(x), tcfg)
    assert row_rel(torch.cat(outs, dim=1), full.detach()) < TOL


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_bf16_gate_matrices_match_reference(kind):
    """``gate_dtype="bf16"`` rounds the (L, L, H) weights to bf16 before
    their product, on both sides; the result moves off the fp32 gates."""
    arch, stack, jfn, tfn = LAYERS[kind]
    x = _np(2, 2, 32, 64)
    outs = {}
    for gate in ("fp32", "bf16"):
        jcfg, tcfg, jp, tp = _layer(arch, stack, kind, gate_dtype=gate)
        ref, _ = jfn(jp, jnp.asarray(x), jcfg)
        out, _ = tfn(tp, torch.from_numpy(x), tcfg)
        assert row_rel(out, ref) < TOL
        outs[gate] = out
    assert row_rel(outs["bf16"], outs["fp32"].numpy()) > 10 * TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_conv_sums_taps_in_fp32(dtype):
    """The taps are summed in fp32 and the sum cast once, as the
    reference: equal bitwise in bf16, within fp32 rounding in fp32."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, w, b = _np(3, 2, 9, 40), _np(4, 4, 40), _np(5, 40)
    ref = jmamba2._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt))
    out = tmamba2._causal_conv(*(torch.from_numpy(a).to(dtype) for a in (x, w, b)))
    assert out.dtype == dtype
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(out.float().numpy(), ref)
    assert row_rel(out.float(), ref) < TOL


def test_softplus_is_jax_softplus_above_the_torch_threshold():
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.0, 20.5, 25.0, 60.0], np.float32)
    np.testing.assert_allclose(tmamba2.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-7)


def test_cached_step_takes_one_token():
    jcfg, tcfg, jp, tp = _layer(*LAYERS["mamba"][:2], "mamba")
    cache = tmamba2.mamba2_cache(tcfg, 2, torch.float32, CPU)
    with pytest.raises(ValueError, match="one token"):
        tmamba2.mamba2(tp, torch.zeros(2, 2, tcfg.d_model), tcfg, cache, 0)
    s_cache = txlstm.slstm_cache(tcfg, 2, CPU)
    assert len({id(t) for t in s_cache.values()}) == 3       # three tensors, each its own


@pytest.mark.parametrize("kind", list(LAYERS))
def test_block_matches_reference(kind):
    """``block_apply`` (pre-norm + residual) uncached and for one cached
    step, against the reference's; aux 0."""
    arch, stack, _, _ = LAYERS[kind]
    jcfg, _, jparams, tcfg, _, tparams = _models(arch)
    jp = jax.tree.map(lambda a: a[0], jparams[stack])
    tp = tparams[stack][0]
    x = _np(6, 2, 16, tcfg.d_model)
    pos = np.arange(16)
    ref, ref_aux, _ = jblocks.block_apply(jp, jnp.asarray(x), jcfg, kind, jnp.asarray(pos))
    out, aux, _ = tblocks.block_apply(tp, torch.from_numpy(x), tcfg, kind,
                                      torch.from_numpy(pos))
    assert row_rel(out, ref) < TOL and float(aux) == float(ref_aux) == 0.0
    jc, tc = _caches(kind, jcfg, tcfg, 2)
    ref, _, _ = jblocks.block_apply(jp, jnp.asarray(x[:, :1]), jcfg, kind, jnp.zeros(1, int),
                                    jc, jnp.int32(0))
    out, _, _ = tblocks.block_apply(tp, torch.from_numpy(x[:, :1]), tcfg, kind,
                                    torch.zeros(1, dtype=torch.int64), tc, 0)
    assert row_rel(out, ref) < TOL


# -- models -----------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


def test_configs_hold_the_reference(arch):
    from repro.configs import get_config as jax_get_config

    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        # the reference's fields, and the port's own at the defaults that keep them
        assert dataclasses.asdict(port) == {**dataclasses.asdict(ref), **port_only_defaults()}
    model = build_model(get_config(arch))
    assert type(model).__name__ == {"zamba2-2.7b": "HybridLM", "xlstm-350m": "XLSTMLM"}[arch]
    assert not hasattr(model, "prefill")
    assert not getattr(model, "supports_position_offsets", False)


def test_full_width_shapes():
    """zamba2-2.7b: 54 Mamba layers in 9 groups of 6, in_proj 2560 -> 10448,
    80 SSM heads of 64; xlstm-350m: 6 groups of mmm-s, 4 heads of 256."""
    z = build_model(get_config("zamba2-2.7b"))
    assert (z.n_groups, z.cfg.shared_attn_every) == (9, 6)
    assert tmamba2.dims(z.cfg) == (5120, 64, 80, 64)
    assert 2 * 5120 + 2 * 64 + 80 == 10448
    x = build_model(get_config("xlstm-350m"))
    assert (x.n_groups, x.n_m, x.n_s) == (6, 3, 1)
    assert x.param_stacks() == [("m_layers", 18), ("s_layers", 6)]


def test_forward_and_loss_match_reference(arch):
    """Logits per row within ``TOL`` over the real vocabulary, the loss
    within 1e-5 relative; S = 32 is two SSD / mLSTM chunks."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _models(arch)
    v = tcfg.vocab_size
    rng = np.random.default_rng(20)
    tokens = rng.integers(0, v, size=(2, 32))
    labels = rng.integers(0, v, size=(2, 32))
    labels[0, :5] = -100
    ref, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    ref_loss, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens),
                                        "labels": jnp.asarray(labels)})
    with torch.no_grad():
        out, aux = tmodel.forward(tparams, torch.from_numpy(tokens))
        loss, parts = tmodel.loss(tparams, {"tokens": torch.from_numpy(tokens),
                                            "labels": torch.from_numpy(labels)})
    assert out.shape == (2, 32, 256) and float(aux) == 0.0
    assert row_rel(out[..., :v], np.asarray(ref)[..., :v]) < TOL
    assert abs(float(loss) - float(ref_loss)) < 1e-5 * abs(float(ref_loss))
    assert float(parts["ce"]) == float(loss)


def test_every_decode_step_matches_reference(arch):
    """24 decode steps (the slot a 0-d tensor) from a fresh cache: each
    step's logits within ``TOL`` of the reference's step."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _models(arch)
    v = tcfg.vocab_size
    tokens = np.random.default_rng(21).integers(0, v, size=(2, 24))
    jc = jmodel.init_cache(2, 32)
    tc = tmodel.init_cache(2, 32, CPU)
    step = jax.jit(jmodel.decode_step)
    for t in range(24):
        ref, jc = step(jparams, jc, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        with torch.no_grad():
            out, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tokens[:, t:t + 1]),
                                         torch.tensor(t))
        assert row_rel(out[:, :v], np.asarray(ref)[:, :v]) < TOL, t


def test_decode_matches_forward_bf16(arch):
    """``tests/test_models.py::test_decode_matches_forward`` on the port:
    bf16, step-by-step decode logits against the uncached forward, the
    worst error within 0.08 of the largest logit."""
    *_, tmodel, tparams = _models(arch, "bfloat16")
    v = tmodel.cfg.vocab_size
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, v, size=(2, 24)))
    with torch.no_grad():
        fwd, _ = tmodel.forward(tparams, tokens)
        cache = tmodel.init_cache(2, 24, CPU)
        errs = []
        for t in range(24):
            logits, cache = tmodel.decode_step(tparams, cache, tokens[:, t:t + 1], t)
            errs.append((logits[:, :v] - fwd[:, t, :v]).abs().max().item())
    assert max(errs) / fwd[..., :v].abs().max().item() < BF16_DECODE_TOL


def test_generate_tokens_match_reference_on_a_padded_batch(arch):
    """``generate(lens=)`` on a left-padded batch, greedy: the same tokens
    as the reference's ``generate`` on the same batch.  Neither passes
    offsets to these models: the pads run through the recurrence."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _models(arch)
    batch, lens = batch_requests(PROMPTS)
    scfg = dict(max_new_tokens=8, max_seq=32)
    ref = jax_generate(jmodel, jparams, batch, JaxServeConfig(**scfg), lens=lens)
    out = generate(tmodel, tparams, batch, ServeConfig(**scfg), lens=lens)
    assert out.shape == (4, 15)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_pad_tokens_run_through_the_recurrence_as_in_the_reference(arch):
    """The reference behaviour the port copies (``ROADMAP.md`` §3): a
    12-token prompt left-padded by 4 has other last-token logits than the
    same prompt alone, on both packages alike (fp32 smoke: 0.131 max abs
    for zamba2, 0.429 for xlstm)."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _models(arch)
    v = tcfg.vocab_size
    prompt = np.random.default_rng(0).integers(1, v, size=12)
    padded = np.concatenate([np.zeros(4, np.int64), prompt])[None]
    moved = {}
    step = jax.jit(jmodel.decode_step)
    for name, toks in (("alone", prompt[None]), ("padded", padded)):
        jc = jmodel.init_cache(1, 32)
        ref = None
        for t in range(toks.shape[1]):
            ref, jc = step(jparams, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        with torch.no_grad():
            out = prefill(tmodel, tparams, tmodel.init_cache(1, 32, CPU),
                          torch.from_numpy(toks))
        assert row_rel(out[:, :v], np.asarray(ref)[:, :v]) < TOL
        moved[name] = (out[:, :v].numpy(), np.asarray(ref)[:, :v])
    port_move = np.abs(moved["padded"][0] - moved["alone"][0]).max()
    ref_move = np.abs(moved["padded"][1] - moved["alone"][1]).max()
    print(f"last-token logits moved by {port_move:.4f} (reference {ref_move:.4f}), "
          f"{port_move / np.linalg.norm(moved['alone'][0]):.3f} of the row's L2 norm")
    assert port_move > 0.05 and abs(port_move - ref_move) < 1e-4 * max(ref_move, 1.0)


def test_server_tokens_match_reference_generate(arch):
    """``Server`` (bucket 4x16) against the reference's ``generate`` on the
    same bucket-padded batch; a request alone decodes as its row did."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _models(arch)
    scfg = dict(max_new_tokens=6, max_seq=32)
    srv = Server(tmodel, tparams, ServeConfig(**scfg), buckets=[(4, 16)])
    srv.warmup()
    res = srv.generate(PROMPTS)
    batch, lens = batch_requests(PROMPTS, PAD_ID, pad_to=16)
    full = jax_generate(jmodel, jparams, batch, JaxServeConfig(**scfg), lens=lens)
    assert res.bucket == "4x16"
    assert res.sequences == [full[i, 16 - int(lens[i]):].tolist() for i in range(4)]
    alone = srv.generate([PROMPTS[1]])
    assert alone.new_tokens[0] == res.new_tokens[1]
    dummies = [[DUMMY_TOKEN]] * 3
    batch, lens = batch_requests([PROMPTS[1]] + dummies, PAD_ID, pad_to=16)
    assert alone.sequences[0] == np.asarray(jax_generate(
        jmodel, jparams, batch, JaxServeConfig(**scfg), lens=lens))[0, 11:].tolist()


def test_slot_bound_is_the_shared_kv_for_the_hybrid_only():
    """The hybrid's shared attention caches ``max_seq`` slots: a step past
    them raises; xLSTM's state has no slots, so nothing to check."""
    *_, zmodel, _ = _models("zamba2-2.7b")
    *_, xmodel, _ = _models("xlstm-350m")
    zc, xc = zmodel.init_cache(2, 8, CPU), xmodel.init_cache(2, 8, CPU)
    zmodel.check_decode_pos(zc, 7)
    with pytest.raises(ValueError, match="overruns"):
        zmodel.check_decode_pos(zc, 8)
    xmodel.check_decode_pos(xc, 10_000)
    assert len(zc["mamba"]) == 4 and len(zc["shared"]) == 2
    assert len(xc["m"]) == 3 and len(xc["s"]) == 1


def test_params_and_optimizer_state_cross_both_ways_bitwise(arch):
    """The reference's tree (``mamba_layers`` stacked, ``shared_in``, the
    unstacked ``shared`` block; ``m_layers`` / ``s_layers``) into the port
    and back, leaf for leaf, bf16 kept; AdamW state too."""
    from repro.optim import adamw as jax_adamw

    jcfg, _, jparams, tcfg, _, _ = _models(arch, "bfloat16")
    back = params_to_jax(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, CPU))
    assert jax.tree.structure(jparams) == jax.tree.structure(
        jax.tree.map(lambda t: 0, back, is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(
            back, is_leaf=torch.is_tensor)):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    jstate = jax_adamw.init(jparams)
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, CPU)
    sback = state_to_jax(tstate)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(sback, is_leaf=torch.is_tensor)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_a_tree_with_the_wrong_depth_is_refused():
    jcfg, _, jparams, tcfg, _, _ = _models("zamba2-2.7b")
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="tree has 4 mamba_layers, config 6"):
        params_from_jax(tree, dataclasses.replace(tcfg, num_layers=6, shared_attn_every=3),
                        CPU)


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_serves_the_smoke_model_on_cpu(name, capsys):
    from repro_torch.launch import serve as launch_serve

    assert launch_serve.main(["--arch", name, "--smoke", "--device", "cpu", "--max-new", "3",
                              "--buckets", "4x16"]) == 0
    out = capsys.readouterr().out
    assert f"arch={get_smoke_config(name).name}" in out and "bucket=4x16" in out
