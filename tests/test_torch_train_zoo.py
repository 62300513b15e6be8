"""Every model family's training step in the port against the JAX package's,
on the CPU.

Each case builds the JAX smoke config and the port's at ``dtype="float32"``,
carries the reference's weights across with ``checkpoint.convert``, and
holds ``Trainer.loss_and_grads`` against ``jax.value_and_grad`` of the
reference's ``loss`` on a batch from a numpy generator with seed 2 (2 x 32
tokens; seamless-m4t-medium also a seeded ``src_embed``), under
``remat="none"`` and under ``"dots"`` on both sides.

zamba2-2.7b's reference gradients are NaN: its SSD chunk scan takes the
``exp`` of positive decays above the diagonal before masking them
(``repro_torch.layers.mamba2.causal_gate``).  Its case therefore holds the
port against the reference with ``_ssd_chunk_scan`` swapped for
``_masked_ssd_chunk_scan`` below, a ``jnp`` copy with the mask moved before
the ``exp``, for that test only; a second test pins the reference's own
non-finite gradients beside the port's finite ones.

The compiled step (``runtime.train.StaticStep``, the body a card captures
as one CUDA graph) of every family the launcher trains, run eagerly here:
bitwise the eager step over 8 steps, and the reference's ``jax.jit``
trainer's 8-step loss curve at ``CURVE_TOL`` (zamba2's with the mask before
the ``exp``, as above); the smoke Llama's and the meshes' cases are in
``tests/test_torch_train_graph.py``.

Also here: the compute types the trainer casts each master to (the
reference's ``_dtypes``), the scans' forwards bitwise against the
reference's expression of the gate, and the MoE's routing recomputed
under ``"dots"`` where capacity drops tokens.

Tolerances: fp32 loss and gradients 1e-5 relative L2 per leaf (both sides
fp32, sums in other orders), as ``tests/test_torch_train.py``; zamba2's
``A_log`` gradients 1e-4 (``A_LOG_TOL``).  ``A_log`` reaches the loss through
the decays' differences ``cum_i - cum_j``, whose gradients cancel almost
exactly, so fp32 sums in any order land 1e-5 to 3e-5 from the fp64 value:
in a CPU probe of this case both packages did (the port 4.9e-6 to 2.8e-5
per layer, the reference 6.2e-6 to 2.6e-5), the reference's eager and jit
gradients differ by up to 7.1e-6 between themselves, and the port and the
reference by up to 1.7e-5.  Every other zamba2 leaf is held to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.layers import mamba2 as jmamba2
from repro.models.registry import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.runtime.train import TrainConfig as JaxTrainConfig, Trainer as JaxTrainer
from repro_torch.checkpoint import params_from_jax, state_from_jax
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_iterator, device_put_batch
from repro_torch.layers import mamba2 as tmamba2
from repro_torch.layers import moe as tmoe
from repro_torch.layers import xlstm as txlstm
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.train import TrainConfig, Trainer
from repro_torch.tree import tree_leaves, tree_map, tree_paths

TOL = 1e-5
A_LOG_TOL = 1e-4
# the 8-step loss curve, as test_torch_train.py's
CURVE_TOL, CURVE_STEPS = 1e-4, 8
BATCH, SEQ, SRC = 2, 32, 16
ZOO = ("deepseek-moe-16b", "qwen3-moe-30b-a3b", "minicpm3-4b", "xlstm-350m",
       "seamless-m4t-medium")
HYBRID = "zamba2-2.7b"


def _rel_l2(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.linalg.norm(port - ref) / (np.linalg.norm(ref) + 1e-30))


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _paths(tree):
    return {"//".join(map(str, p)): leaf for p, leaf in tree_paths(tree)}


def _batch(cfg):
    """2 x 32 tokens and their next tokens from numpy seed 2; the encoder-
    decoder's source frames after them."""
    rng = np.random.default_rng(2)
    tok = rng.integers(1, cfg.vocab_size, size=(BATCH, SEQ + 1), dtype=np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "audio":
        batch["src_embed"] = rng.standard_normal((BATCH, SRC, cfg.d_model), dtype=np.float32)
    return batch


def _masked_ssd_chunk_scan(xh, dt, Bm, Cm, A, chunk: int, gate_dtype=None):
    """``repro.layers.mamba2._ssd_chunk_scan`` with the causal mask moved
    before the ``exp``: ``exp(where(mask, decay, -inf))``."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    pad = (-s) % chunk
    if pad:
        z = lambda t: jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))  # noqa: E731
        xh, dt, Bm, Cm = z(xh), z(dt), z(Bm), z(Cm)
        s_orig, s = s, s + pad
    else:
        s_orig = s
    nc, L = s // chunk, chunk

    def toc(t):
        return t.reshape(b, nc, L, *t.shape[2:]).swapaxes(0, 1)

    xc, dtc, Bc, Cc = toc(xh), toc(dt), toc(Bm), toc(Cm)
    la = dtc.astype(jnp.float32) * A

    def body(hstate, args):
        xk, dtk, Bk, Ck, lak = args
        cum = jnp.cumsum(lak, axis=1)
        scores = jnp.einsum("bin,bjn->bij", Ck.astype(jnp.float32), Bk.astype(jnp.float32))
        decay = cum[:, :, None, :] - cum[:, None, :, :]
        mask = jnp.tril(jnp.ones((L, L), bool))
        gate = jnp.exp(jnp.where(mask[None, :, :, None], decay, -jnp.inf))
        w = scores[..., None] * gate * dtk[:, None, :, :]
        if gate_dtype is not None:
            w = w.astype(gate_dtype)
        y = jnp.einsum("bijh,bjhp->bihp", w, xk.astype(w.dtype),
                       preferred_element_type=jnp.float32)
        y = y + jnp.einsum("bin,bhpn,bih->bihp", Ck.astype(jnp.float32), hstate, jnp.exp(cum))
        tot = cum[:, -1:, :]
        carry_decay = jnp.exp(tot - cum)
        hnew = jnp.einsum("bjh,bjn,bjhp->bhpn", carry_decay * dtk, Bk.astype(jnp.float32),
                          xk.astype(jnp.float32))
        hstate = hstate * jnp.exp(tot[:, 0, :])[:, :, None, None] + hnew
        return hstate, y

    h0 = jnp.zeros((b, h, p, n), jnp.float32)
    hfin, yc = jax.lax.scan(body, h0, (xc, dtc, Bc, Cc, la))
    return yc.swapaxes(0, 1).reshape(b, s, h, p)[:, :s_orig], hfin


@pytest.fixture(scope="module")
def reference():
    """``reference(arch, remat, masked=False)``: (port cfg, port params,
    the numpy batch, the reference's loss, parts and gradients in the
    port's layout), computed once per module and case."""
    cache = {}

    def get(arch, remat, masked=False):
        key = (arch, remat, masked)
        if key not in cache:
            jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32", remat=remat)
            tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", remat=remat)
            jmodel = jax_build_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            nb = _batch(tcfg)
            fn = jax.value_and_grad(jmodel.loss, has_aux=True)
            with pytest.MonkeyPatch.context() as mp:
                if masked:
                    mp.setattr(jmamba2, "_ssd_chunk_scan", _masked_ssd_chunk_scan)
                (loss, parts), grads = fn(jparams, {k: jnp.asarray(v) for k, v in nb.items()})
            to_port = lambda t: params_from_jax(jax.tree.map(np.asarray, t), tcfg,  # noqa: E731
                                                device="cpu")
            cache[key] = (tcfg, to_port(jparams), nb, float(loss),
                          {k: float(v) for k, v in parts.items()}, to_port(grads))
        return cache[key]

    return get


def _port_step(tcfg, tparams, nb):
    master = tree_map(lambda t: t.clone(), tparams)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
    loss, parts, grads = Trainer(build_model(tcfg), TrainConfig(), device="cpu").loss_and_grads(
        master, batch)
    return float(loss), {k: float(v) for k, v in parts.items()}, dict(zip(_paths(master), grads))


def _assert_matches(got, ref, leaf_tol=lambda key: TOL):
    loss, parts, grads = got
    _, _, _, rloss, rparts, rgrads = ref
    assert _rel_l2(loss, rloss) < TOL
    assert set(parts) == set(rparts)
    for k in parts:
        assert _rel_l2(parts[k], rparts[k]) < TOL, k
    want = _paths(rgrads)
    assert set(grads) == set(want)
    for key, g in grads.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), key
        assert _rel_l2(_np(g), _np(want[key])) < leaf_tol(key), key


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", ZOO)
def test_loss_and_every_gradient_match_jax_grad(reference, arch, remat):
    ref = reference(arch, remat)
    _assert_matches(_port_step(*ref[:3]), ref)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_zamba2_matches_the_reference_with_the_mask_before_the_exp(reference, remat):
    ref = reference(HYBRID, remat, masked=True)
    _assert_matches(_port_step(*ref[:3]), ref,
                    lambda key: A_LOG_TOL if key.endswith("A_log") else TOL)


def test_zamba2_reference_grads_are_nonfinite_and_the_ports_finite_as_the_reference_does(
        reference):
    """The reference's own scan: the same loss, NaN in most gradient leaves
    (every one upstream of a Mamba layer's scan); the port's all finite."""
    ref = reference(HYBRID, "none")
    loss, _, grads = _port_step(*ref[:3])
    assert _rel_l2(loss, ref[3]) < TOL
    bad = [k for k, g in _paths(ref[5]).items() if not np.isfinite(_np(g)).all()]
    assert len(bad) > len(grads) // 2
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


# -- the two repairs ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_the_trainer_feeds_the_loss_the_references_compute_types(arch):
    """bf16 smoke configs: each leaf the trainer hands ``model.loss`` has the
    type the reference's trainer casts it to (``_dtypes``, the types
    ``model.init`` gave): the MoE router, xLSTM's ``w_gates``, ``w_in`` and
    ``r`` fp32, Mamba-2's ``conv_b`` bf16.  The types come from an init
    without numbers when the trainer was handed its state."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jt = JaxTrainer(jax_build_model(jcfg), JaxTrainConfig())
    jt.init_state(jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda d, p: np.zeros(p.shape, d), jt._dtypes,
                         jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    want = {k: t.dtype for k, t in _paths(params_from_jax(zeros, tcfg, device="cpu")).items()}
    model = build_model(tcfg)
    seen = {}
    real_loss = model.loss

    def spy(params, batch):
        seen.update({k: t.dtype for k, t in _paths(params).items()})
        return real_loss(params, batch)

    model.loss = spy
    batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
             for k, v in _batch(tcfg).items()}
    for how in ("init_state", "handed a state"):
        trainer = Trainer(model, TrainConfig(), device="cpu")
        state = trainer.init_state(torch.Generator().manual_seed(0)) if how == "init_state" \
            else adamw.init(model.init(torch.Generator().manual_seed(0), "cpu"))
        seen.clear()
        trainer.loss_and_grads(state["master"], batch)
        assert seen == want, how
    if arch in ("deepseek_moe_16b", "xlstm_350m", "zamba2_2_7b"):
        special = {"deepseek_moe_16b": ("router", torch.float32),
                   "xlstm_350m": ("w_gates", torch.float32),
                   "zamba2_2_7b": ("conv_b", torch.bfloat16)}[arch]
        assert [d for k, d in want.items() if k.endswith(special[0])][0] == special[1]


def test_a_handed_state_keeps_the_init_types_where_the_reference_makes_them_bf16(capsys):
    """``fit`` with a state (a checkpoint): the port casts each leaf to its
    ``model.init`` type, the norms fp32; the reference's restore branch
    casts every fp32 master to bf16."""
    cfg = get_smoke_config("zamba2-2.7b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    trainer = Trainer(model, TrainConfig(steps=1, log_every=1), device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(cfg).items()}
    trainer.fit(None, iter([batch]), state=adamw.init(params))
    got = _paths(trainer.compute_dtypes())
    assert got == {k: t.dtype for k, t in _paths(params).items()}
    assert got["final_norm"] == torch.float32 and got["mamba_layers//0//mamba//conv_b"] == \
        torch.bfloat16


def _old_gate(mask, decay):
    """The reference's expression of the gate: ``where(mask, exp(decay), 0)``."""
    return torch.where(mask, torch.exp(decay), 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scan", ["ssd", "mlstm"])
def test_scan_forward_is_bitwise_the_references_expression(scan, dtype, monkeypatch):
    """S = 40 over chunks of 16 (a padded last chunk); the decays large
    enough that the masked entries' ``exp`` overflows."""
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))  # noqa: E731
    b, s, h, d = 2, 40, 3, 8
    if scan == "ssd":
        args = (f(b, s, h, d).to(dtype), f(b, s, h).abs() * 8, f(b, s, 4).to(dtype),
                f(b, s, 4).to(dtype), -torch.tensor([1.0, 4.0, 16.0]), 16)
        fn = tmamba2._ssd_chunk_scan
    else:
        args = (f(b, s, h, d).to(dtype), f(b, s, h, d).to(dtype), f(b, s, h, d).to(dtype),
                torch.nn.functional.logsigmoid(f(b, s, h)),
                torch.nn.functional.logsigmoid(f(b, s, h) - 6.0), 16)
        fn = txlstm._mlstm_chunk_scan
    for gate_dtype in (None, torch.bfloat16):
        new = fn(*args, gate_dtype=gate_dtype)
        with monkeypatch.context() as m:
            m.setattr(tmamba2, "causal_gate", _old_gate)
            m.setattr(txlstm, "causal_gate", _old_gate)
            old = fn(*args, gate_dtype=gate_dtype)
        for x, y in zip(torch.utils._pytree.tree_leaves(new), torch.utils._pytree.tree_leaves(old)):
            assert torch.equal(x, y)


def test_causal_gate_backward_is_finite_where_the_references_is_nan():
    decay = torch.tensor([[0.0, 200.0], [-1.0, 0.0]], requires_grad=True)
    mask = torch.tril(torch.ones(2, 2, dtype=torch.bool))
    (g_new,) = torch.autograd.grad(tmamba2.causal_gate(mask, decay).sum(), decay)
    (g_old,) = torch.autograd.grad(_old_gate(mask, decay).sum(), decay)
    assert torch.isnan(g_old[0, 1]) and bool(torch.isfinite(g_new).all())
    assert torch.equal(g_new, _old_gate(mask, decay.detach()))


# -- the MoE's routing under recompute ---------------------------------------------------------

def test_moe_dots_gradients_equal_none_where_capacity_drops_tokens(monkeypatch):
    """deepseek's smoke model at capacity factor 0.5: the recomputed routing
    (stable top-k, slots by ``cumsum``) dispatches as the first forward
    did, so "dots" gives "none"'s gradients bit for bit."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"), dtype="float32",
                              capacity_factor=0.5)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(cfg).items()}
    dropped = []
    real = tmoe.moe

    def spy(p, x, c):
        xf = x.detach().float().reshape(-1, min(c.moe_group_size, x.shape[1]), x.shape[-1])
        probs = torch.softmax(torch.einsum("ngd,de->nge", xf, p["router"].detach().float()), -1)
        _, idx = tmoe.top_k(probs, c.top_k)
        per_expert = tmoe._one_hot(idx, c.num_experts).sum(dim=(1, 2))       # (N, E)
        cap = tmoe._capacity(xf.shape[1], c.num_experts, c.top_k, c.capacity_factor)
        dropped.append(float((per_expert - cap).clamp(min=0).sum()))
        return real(p, x, c)

    monkeypatch.setattr("repro_torch.layers.blocks.moe", spy)
    out = {}
    for remat in ("none", "dots"):
        dropped.clear()
        master = tree_map(lambda t: t.clone(), params)
        out[remat] = Trainer(build_model(dataclasses.replace(cfg, remat=remat)), TrainConfig(),
                             device="cpu").loss_and_grads(master, batch)
        assert sum(dropped) > 0, remat
    assert torch.equal(out["none"][0], out["dots"][0])
    for g0, g1 in zip(out["none"][2], out["dots"][2]):
        assert torch.equal(g0, g1)


# -- the compiled step ------------------------------------------------------------------------

def _curve(trainer, state, static: bool):
    """8 steps of 4 x 16 synthetic tokens through the trainer's
    ``StaticStep`` or its eager function: (state, losses, learning rates)."""
    dc = DataConfig(vocab_size=trainer.model.cfg.vocab_size, seq_len=16, global_batch=4)
    data = batch_iterator(dc)
    run = trainer.static_step(state) if static else trainer.make_train_step()
    losses, lrs = [], []
    for _ in range(CURVE_STEPS):
        batch = device_put_batch(next(data), "cpu")
        if static:
            out = run(batch)
        else:
            state, out = run(state, batch)
        losses.append(out["loss"].clone())
        lrs.append(out["lr"].clone())
    return state, losses, lrs


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a not in ("llama3_2_1b", "seamless_m4t_medium")])
def test_the_static_step_is_the_eager_step_and_the_reference_curve(arch, monkeypatch):
    """fp32 smoke configs under their full configs' remat policies, from the
    reference's init at ``PRNGKey(0)``: the static step's state, losses and
    learning rates bitwise the eager step's, its losses the reference
    trainer's."""
    remat = get_config(arch).remat
    jmodel = jax_build_model(dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                                                 remat=remat))
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", remat=remat)
    kw = dict(steps=CURVE_STEPS, lr=1e-3, warmup=2)
    with monkeypatch.context() as mp:
        if arch == "zamba2_2_7b":
            mp.setattr(jmamba2, "_ssd_chunk_scan", _masked_ssd_chunk_scan)
        ref = JaxTrainer(jmodel, JaxTrainConfig(log_every=1, **kw)).fit(
            jax.random.PRNGKey(0), jax_pipeline.batch_iterator(jax_pipeline.DataConfig(
                vocab_size=tcfg.vocab_size, seq_len=16, global_batch=4)))
    np_state = jax.tree.map(np.asarray, jax_adamw.init(jmodel.init(jax.random.PRNGKey(0))))
    runs = [_curve(Trainer(build_model(tcfg), TrainConfig(**kw), device="cpu"),
                   state_from_jax(np_state, tcfg, device="cpu"), static)
            for static in (True, False)]
    (s1, l1, r1), (s0, l0, r0) = runs
    assert int(s1["step"]) == CURVE_STEPS
    for a, b in zip(tree_leaves(s1), tree_leaves(s0)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(l1 + r1, l0 + r0))
    np.testing.assert_allclose([float(x) for x in l1], [h["loss"] for h in ref["history"]],
                               rtol=CURVE_TOL)
