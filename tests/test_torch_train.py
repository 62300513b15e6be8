"""The port's training path against the JAX package's, on the CPU.

Gradients through the Z-order kernel's autograd node, the model's loss and
remat policies, AdamW, the synthetic data, checkpoints (both directions
between the packages), the trainer's loss curve and its restart, and the
launcher.  Parameters come from the reference's smoke model through
``checkpoint.convert``; everything random is numpy or the reference's own
seeded init.  The CUDA side of the same path runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 14).

Tolerances: fp32 gradients 1e-5 relative L2 per leaf (both sides fp32,
the order of sums differs); one AdamW step 1e-6 (elementwise fp32, one
rounding apart at most); the loss curve 1e-4 (eight steps compound the
gradients' differences); data and checkpoints bitwise.
"""
import dataclasses
import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.models.registry import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.runtime.train import TrainConfig as JaxTrainConfig, Trainer as JaxTrainer
from repro_torch.checkpoint import (params_from_jax, params_to_jax, state_from_jax,
                                    state_to_jax, store)
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data.pipeline import (DataConfig, batch_iterator, device_put_batch,
                                       synth_batch)
from repro_torch.dist import Mesh, symmetric_matmul
from repro_torch.kernels.flash_attention import mha
from repro_torch.kernels.matmul import ops
from repro_torch.launch import train as launch_train
from repro_torch.layers.linear import linear
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.plan import planned_matmuls
from repro_torch.runtime.sharding import unplace
from repro_torch.runtime.train import TrainConfig, Trainer
from repro_torch.tree import tree_leaves, tree_map, tree_paths

ARCH = "llama3_2_1b"
# the autograd node of the registered op ``repro_torch::zorder_matmul``
K1_NODE = "GeneratedBackwardFor_repro_torch_zorder_matmul_defaultBackward"


def _rel_l2(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.linalg.norm(port - ref) / (np.linalg.norm(ref) + 1e-30)


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _paths(tree):
    return {"//".join(map(str, p)): leaf for p, leaf in tree_paths(tree)}


@pytest.fixture(scope="module")
def fp32_pair():
    """(jax model, jax params, port model, port params): the fp32 smoke
    Llama, the port's weights the reference's."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def _batch(vocab, seq=64, batch=2, step=0):
    return synth_batch(DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch), step)


def _k1_nodes(t):
    seen, todo, found = set(), [t.grad_fn], 0
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        found += node.name() == K1_NODE
        todo.extend(nxt for nxt, _ in node.next_functions)
    return found


# -- the loss and its gradients ----------------------------------------------------

def test_loss_and_every_gradient_match_jax_grad(fp32_pair):
    """S = 64 over attn_chunk = 32: the chunk loop runs in both."""
    jmodel, jparams, model, tparams = fp32_pair
    nb = _batch(model.cfg.vocab_size)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in nb.items()})
    trainer = Trainer(model, TrainConfig(), device="cpu")
    master = tree_map(lambda t: t.clone(), tparams)
    loss, metrics, grads = trainer.loss_and_grads(master, device_put_batch(nb, "cpu"))
    assert _rel_l2(_np(loss), np.asarray(jloss)) < 1e-5
    assert set(metrics) == {"ce", "aux"}
    want = _paths(params_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg, device="cpu"))
    got = dict(zip(_paths(master), grads))
    assert set(got) == set(want) and len(got) == 2 + 9 * model.cfg.num_layers
    for key, g in got.items():
        assert g.dtype == torch.float32
        assert np.linalg.norm(_np(want[key])) > 0, key
        assert _rel_l2(_np(g), _np(want[key])) < 1e-5, key


def test_every_projection_is_a_kernel_node(fp32_pair):
    """The loss's graph holds one K1 op node per projection and one for the
    unembedding: the gradient of every projection weight and of the head
    is the kernel's own backward."""
    _, _, model, tparams = fp32_pair
    params = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    loss, _ = model.loss(params, device_put_batch(_batch(model.cfg.vocab_size, 16), "cpu"))
    assert _k1_nodes(loss) == 7 * model.cfg.num_layers + 1
    with torch.no_grad():
        assert model.loss(params, device_put_batch(_batch(256, 16), "cpu"))[0].grad_fn is None


def test_remat_full_gives_the_gradients_of_none(fp32_pair):
    _, _, model, tparams = fp32_pair
    batch = device_put_batch(_batch(model.cfg.vocab_size), "cpu")
    out = {}
    for remat in ("none", "full"):
        m = build_model(dataclasses.replace(model.cfg, remat=remat))
        master = tree_map(lambda t: t.clone(), tparams)
        out[remat] = Trainer(m, TrainConfig(), device="cpu").loss_and_grads(master, batch)
    assert torch.equal(out["none"][0], out["full"][0])
    for g0, g1 in zip(out["none"][2], out["full"][2]):
        torch.testing.assert_close(g1, g0, rtol=1e-6, atol=0)


def _grads_and_products(model, tparams, batch, monkeypatch):
    """(loss, gradients, plain-version products) of one trainer step."""
    calls = []
    real = ops.matmul_ref
    monkeypatch.setattr(ops, "matmul_ref", lambda *a, **k: calls.append(1) or real(*a, **k))
    master = tree_map(lambda t: t.clone(), tparams)
    loss, _, grads = Trainer(model, TrainConfig(), device="cpu").loss_and_grads(master, batch)
    monkeypatch.setattr(ops, "matmul_ref", real)
    return loss, grads, len(calls)


def test_remat_dots_gives_the_gradients_of_none(fp32_pair, monkeypatch):
    _, _, model, tparams = fp32_pair
    batch = device_put_batch(_batch(model.cfg.vocab_size), "cpu")
    out = {remat: _grads_and_products(build_model(dataclasses.replace(model.cfg, remat=remat)),
                                      tparams, batch, monkeypatch)
           for remat in ("none", "dots")}
    assert torch.equal(out["none"][0], out["dots"][0])
    for g0, g1 in zip(out["none"][1], out["dots"][1]):
        torch.testing.assert_close(g1, g0, rtol=1e-6, atol=0)
    assert get_config("h2o-danube-3-4b").remat == "dots"


def test_remat_dots_recomputes_no_product(fp32_pair, monkeypatch):
    """Plain-version products a step: the forward's, dA and dB under
    "none" and "dots" (the products' outputs are saved), the layers'
    forward products once more under "full" (the unembedding, outside the
    blocks, is not recomputed)."""
    _, _, model, tparams = fp32_pair
    batch = device_put_batch(_batch(model.cfg.vocab_size, 32), "cpu")
    calls = {remat: _grads_and_products(build_model(dataclasses.replace(model.cfg, remat=remat)),
                                        tparams, batch, monkeypatch)[2]
             for remat in ("none", "dots", "full")}
    layers = 7 * model.cfg.num_layers
    forward = layers + 1
    assert calls == {"none": 3 * forward, "dots": 3 * forward, "full": 3 * forward + layers}


def test_remat_dots_serves_as_before(fp32_pair, monkeypatch):
    """Without grad a "dots" config runs its blocks as is: the same logits
    bit for bit, one plain-version product a projection and one for the
    unembedding, and the kernel called directly, never through the
    registered op."""
    _, _, model, tparams = fp32_pair
    m = build_model(dataclasses.replace(model.cfg, remat="dots"))
    tokens = torch.from_numpy(_batch(256, 16)["tokens"]).long()
    with torch.no_grad():
        ref = model.forward(tparams, tokens)[0]
        calls = []
        real = ops.matmul_ref
        monkeypatch.setattr(ops, "matmul_ref", lambda *a, **k: calls.append(1) or real(*a, **k))
        monkeypatch.setattr(ops, "zorder_matmul_op", None)    # a call would raise
        torch.testing.assert_close(m.forward(tparams, tokens)[0], ref, rtol=0, atol=0)
    assert len(calls) == 7 * model.cfg.num_layers + 1


@pytest.mark.parametrize("what", ["symmetric_matmul", "planned_linear"])
def test_a_planned_product_has_a_planned_backward(what):
    """Under grad a planned product is differentiable, its dA and dB two
    more planned products (``tests/test_torch_sharding.py`` holds every
    strategy to ``jax.grad``); without grad it is the plain product."""
    mesh = Mesh((2,), ("t",), device="cpu")
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 8, requires_grad=True)
    if what == "symmetric_matmul":
        y = symmetric_matmul(x, w, mesh=mesh)
    else:
        with planned_matmuls(mesh):
            y = linear(x, w)
    assert type(y.grad_fn).__name__ == "_PlannedMatmulBackward"
    dx, dw = torch.autograd.grad(y.sum(), (x, w))
    ones = torch.ones(8, 8)
    torch.testing.assert_close(dx, ones @ w.detach().t(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, x.detach().t() @ ones, rtol=1e-5, atol=1e-5)
    with torch.no_grad(), planned_matmuls(mesh):
        torch.testing.assert_close(linear(x, w), x @ w, rtol=1e-5, atol=1e-5)
    mesh.close()


def test_mha_raises_under_grad_on_the_cpu_too(fp32_pair):
    q = torch.randn(1, 8, 4, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        mha(q, k, k)
    with torch.no_grad():
        assert mha(q, k, k).shape == (1, 8, 4, 16)
    _, _, model, tparams = fp32_pair
    flash = build_model(dataclasses.replace(model.cfg, attn_impl="flash"))
    master = tree_map(lambda t: t.clone(), tparams)
    with pytest.raises(NotImplementedError, match="attn_impl='xla'"):
        Trainer(flash, TrainConfig(), device="cpu").loss_and_grads(
            master, device_put_batch(_batch(256, 16), "cpu"))


# -- AdamW ---------------------------------------------------------------------------

@pytest.mark.parametrize("start, grad_scale", [(0, 1.0), (5, 1.0), (5, 1e4)],
                         ids=["first-step", "later-step", "clipped"])
def test_adamw_step_matches_reference(fp32_pair, start, grad_scale):
    """Master, m, v and the pre-clip grad norm after one step from a state
    with moments (``start`` > 0) or without."""
    _, jparams, model, _ = fp32_pair
    rng = np.random.default_rng(start)
    rnd = lambda p, s=1.0: jnp.asarray(rng.standard_normal(p.shape, dtype=np.float32) * s)  # noqa: E731
    jstate = jax_adamw.init(jparams)
    if start:
        jstate = {"step": jnp.int32(start), "master": jstate["master"],
                  "m": jax.tree.map(lambda p: rnd(p, 0.01), jparams),
                  "v": jax.tree.map(lambda p: jnp.abs(rnd(p, 1e-4)), jparams)}
    jgrads = jax.tree.map(lambda p: rnd(p, grad_scale), jparams)
    cfg = jax_adamw.AdamWConfig()
    lr = jax_adamw.warmup_cosine(1e-3, 2, 10)(jnp.int32(start))
    jnew, jmet = jax_adamw.step(jstate, jgrads, lr, cfg)

    state = state_from_jax(jax.tree.map(np.asarray, jstate), model.cfg, device="cpu")
    grads = params_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg, device="cpu")
    tlr = adamw.warmup_cosine(1e-3, 2, 10)(state["step"])
    new, met = adamw.step(state, grads, tlr, adamw.AdamWConfig(**dataclasses.asdict(cfg)))
    assert int(new["step"]) == start + 1 and new["step"].dtype == torch.int32
    assert _rel_l2(_np(met["grad_norm"]), np.asarray(jmet["grad_norm"])) < 1e-6
    assert _rel_l2(_np(met["lr"]), np.asarray(lr)) < 1e-6
    want = state_to_jax(new)
    for part in ("master", "m", "v"):
        got, ref = _paths(want[part]), _paths(jax.tree.map(np.asarray, jnew[part]))
        for key in ref:
            assert _rel_l2(_np(got[key]), ref[key]) < 1e-6, (part, key)


@pytest.mark.parametrize("step", [0, 10, 100])
def test_warmup_cosine_matches_reference(step):
    ref = jax_adamw.warmup_cosine(3e-4, 10, 100)(jnp.int32(step))
    port = adamw.warmup_cosine(3e-4, 10, 100)
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        assert abs(float(port(s)) - float(ref)) <= 1e-6 * 3e-4


def test_adamw_init_copies_the_params():
    p = {"w": torch.ones(3), "e": torch.ones(2, 2, dtype=torch.bfloat16)}
    state = adamw.init(p)
    state["master"]["w"].add_(1.0)
    assert torch.equal(p["w"], torch.ones(3))
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["master"]))
    assert int(state["step"]) == 0
    assert torch.equal(adamw.params_from_state(state, p)["e"], p["e"])


# -- data ----------------------------------------------------------------------------------

@pytest.mark.parametrize("seed, step, signal", [(0, 0, 0.9), (3, 7, 0.9), (1, 123, 0.0),
                                                (0, 5, 1.0)])
def test_synth_batch_is_the_references_bit_for_bit(seed, step, signal):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=3, seed=seed, signal=signal)
    port = synth_batch(DataConfig(**kw), step)
    ref = jax_pipeline.synth_batch(jax_pipeline.DataConfig(**kw), step)
    for k in ("tokens", "labels"):
        assert port[k].dtype == ref[k].dtype == np.int32
        np.testing.assert_array_equal(port[k], ref[k])
    it = batch_iterator(DataConfig(**kw), start_step=step)
    np.testing.assert_array_equal(next(it)["tokens"], ref["tokens"])


def test_device_put_batch_gives_int64_and_places_on_a_mesh():
    b = device_put_batch(_batch(100, 8), "cpu")
    assert b["tokens"].dtype == b["labels"].dtype == torch.int64
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    placed = device_put_batch(_batch(100, 8), "cpu", mesh=mesh)
    for key, p in placed.items():
        assert p.sharding.spec == (("data",), None) and p.dtype == torch.int64
        half = b[key].shape[0] // 2
        assert torch.equal(p[0], b[key][:half]) and torch.equal(p[2], b[key][half:])
        assert p[0] is p[1] and torch.equal(unplace(p), b[key])
    with pytest.raises(ValueError, match="does not split"):
        device_put_batch({"tokens": np.zeros((3, 8), np.int32)}, "cpu", mesh=mesh)
    mesh.close()


# -- checkpoints -----------------------------------------------------------------------------

def _bits(x):
    """A leaf's bytes as a flat numpy array (bf16 as its 16-bit words)."""
    if torch.is_tensor(x):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().ravel()
    x = np.asarray(x)
    return (x.view(np.int16) if x.dtype.itemsize == 2 and x.dtype.kind == "V"
            or "bfloat16" in str(x.dtype) else x).ravel()


def _assert_bitwise(port_tree, ref_tree):
    got, want = _paths(port_tree), _paths(ref_tree)
    assert set(got) == set(want)
    for key in want:
        assert str(got[key].dtype).replace("torch.", "") == str(np.asarray(want[key]).dtype), key
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]), err_msg=key)


@pytest.fixture(scope="module")
def bf16_reference():
    """The reference's bf16 smoke params and the AdamW state around them."""
    jcfg = jax_smoke_config(ARCH)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    state = jax_adamw.init(params)
    state = {**state, "step": jnp.int32(7),
             "m": jax.tree.map(lambda p: p + 0.5, state["master"])}
    return params, state


@pytest.mark.parametrize("what", ["params", "state"])
def test_a_reference_checkpoint_restores_into_the_port_bitwise(tmp_path, bf16_reference, what):
    jtree = bf16_reference[0 if what == "params" else 1]
    jax_store.save(str(tmp_path), 7, jtree)
    cfg = get_smoke_config(ARCH)
    np_tree = jax.tree.map(np.asarray, jtree)
    if what == "params":
        like = params_from_jax(np_tree, cfg, device="cpu")
        step, got = store.restore(str(tmp_path), params_to_jax(like))
        port = params_from_jax(got, cfg, device="cpu")
        want = params_from_jax(np_tree, cfg, device="cpu")
    else:
        like = state_from_jax(np_tree, cfg, device="cpu")
        step, got = store.restore(str(tmp_path), state_to_jax(like))
        port = state_from_jax(got, cfg, device="cpu")
        want = state_from_jax(np_tree, cfg, device="cpu")
    assert step == 7
    _assert_bitwise(got, np_tree)
    for a, b in zip(tree_leaves(port), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("what", ["params", "state"])
def test_a_port_checkpoint_restores_into_the_reference_bitwise(tmp_path, bf16_reference, what):
    model = build_model(get_smoke_config(ARCH))
    params = model.init(torch.Generator().manual_seed(4), "cpu")
    if what == "params":
        tree = params_to_jax(params)
        template = bf16_reference[0]
    else:
        state = adamw.init(params)
        state["step"] = torch.tensor(3, dtype=torch.int32)
        tree = state_to_jax(state)
        template = bf16_reference[1]
    store.save(str(tmp_path), 3, tree)
    step, got = jax_store.restore(str(tmp_path), template)
    assert step == 3
    _assert_bitwise(tree, got)


def test_async_writer_snapshots_and_latest_points_at_the_newest(tmp_path):
    tree = {"layers": [{"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
                       {"w": torch.full((2, 3), 1.5, dtype=torch.bfloat16)}],
            "step": torch.tensor(4, dtype=torch.int32)}
    writer = store.AsyncWriter()
    writer.save(str(tmp_path), 4, tree)
    tree["layers"][0]["w"].add_(100.0)           # after the snapshot
    writer.wait()
    assert store.latest_step(str(tmp_path)) == 4
    store.save(str(tmp_path), 9, tree)
    assert store.latest_step(str(tmp_path)) == 9
    step, back = store.restore(str(tmp_path), tree, step=4)
    assert step == 4
    assert torch.equal(back["layers"][0]["w"], torch.arange(6.0).reshape(2, 3))
    assert back["layers"][1]["w"].dtype == torch.bfloat16
    assert torch.equal(back["layers"][1]["w"], tree["layers"][1]["w"])
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 4
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000004", "step_00000009"]
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path / "empty"), tree)


# -- the trainer -------------------------------------------------------------------------------

def test_eight_step_loss_curve_matches_the_reference_trainer(fp32_pair, capsys):
    jmodel, jparams, model, _ = fp32_pair
    dc = dict(vocab_size=model.cfg.vocab_size, seq_len=32, global_batch=4)
    kw = dict(steps=8, lr=1e-3, warmup=2, log_every=1)
    ref = JaxTrainer(jmodel, JaxTrainConfig(**kw)).fit(
        jax.random.PRNGKey(0), jax_pipeline.batch_iterator(jax_pipeline.DataConfig(**dc)))
    # the reference's fit draws its start from PRNGKey(0): the same params
    state = state_from_jax(jax.tree.map(np.asarray, jax_adamw.init(jparams)), model.cfg,
                           device="cpu")
    out = Trainer(model, TrainConfig(**kw), device="cpu").fit(
        None, batch_iterator(DataConfig(**dc)), state=state)
    want = [h["loss"] for h in ref["history"]]
    got = [h["loss"] for h in out["history"]]
    assert len(got) == len(want) == 8
    assert [h["step"] for h in out["history"]] == list(range(1, 9))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(out["state"]["step"]) == 8
    assert "[trainer] step     8 loss" in capsys.readouterr().out


def test_restart_and_loss_decreases(tmp_path, capsys):
    """The reference's ``TestTrainer.test_restart_and_loss_decreases``, on
    the port (bf16 smoke Llama, plain versions on the CPU)."""
    cfg = get_smoke_config(ARCH)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tc = TrainConfig(steps=24, lr=1e-3, warmup=4, ckpt_dir=str(tmp_path),
                     ckpt_every=8, log_every=8, fail_at_step=13)
    out = Trainer(build_model(cfg), tc, device="cpu").fit(
        torch.Generator().manual_seed(0), batch_iterator(dc))
    assert out["restarts"] == 1
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert "step 13 failed (injected node failure); restoring step 8" in capsys.readouterr().out
    assert store.latest_step(str(tmp_path)) == 24
    _, saved = store.restore(str(tmp_path), out["state"])
    for a, b in zip(tree_leaves(saved), tree_leaves(out["state"])):
        assert torch.equal(a, b)


def test_too_many_failures_raise(tmp_path):
    cfg = get_smoke_config(ARCH)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    tc = TrainConfig(steps=4, fail_at_step=1, max_restarts=0, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="injected node failure"):
        Trainer(build_model(cfg), tc, device="cpu").fit(
            torch.Generator().manual_seed(0), batch_iterator(dc))


def test_a_trainer_on_a_mesh_places_its_state():
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    trainer = Trainer(build_model(get_smoke_config(ARCH)), TrainConfig(), mesh=mesh)
    assert trainer.mesh is mesh and trainer.device == torch.device("cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    wq = state["master"]["layers"][0]["attn"]["wq"]
    assert wq.sharding.spec == (None, "model") and tuple(wq[0].shape) == (64, 32)
    assert wq[0] is wq[2] and wq[0] is not wq[1]
    assert state["m"]["final_norm"].sharding.spec == () and len(state["m"]["final_norm"]) == 4
    assert Trainer(build_model(get_smoke_config(ARCH)), TrainConfig(),
                   mesh=Mesh((1,), ("t",), device="cpu"), device="cpu").mesh is None
    mesh.close()


def test_launcher_trains_on_cpu_when_asked(tmp_path, capsys):
    assert launch_train.main(["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
                              "--seq", "16", "--ckpt", str(tmp_path), "--tp", "4"]) == 0
    out = capsys.readouterr().out
    assert "--tp 4 ignored" in out and "[launch] done: loss" in out
    assert "zorder_matmul launches: 0" in out
    assert store.latest_step(str(tmp_path)) == 6


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in (ARCH, "seamless_m4t_medium")])
def test_launcher_trains_every_family_on_cpu(arch, capsys):
    """Each config's smoke model through the launcher, with its own remat
    policy set to its full config's (``"dots"`` for all but xLSTM)."""
    full = get_config(arch)
    with mock.patch.object(launch_train, "get_smoke_config",
                           lambda name: dataclasses.replace(get_smoke_config(name),
                                                            remat=full.remat)):
        assert launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                                  "--batch", "2", "--seq", "16"]) == 0
    done = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[launch] done")]
    first, last = (float(x) for x in re.findall(r"loss (\S+) -> (\S+) ", done[0])[0])
    assert np.isfinite(first) and np.isfinite(last)


def test_launcher_refuses_the_encoder_decoder(capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu"])
    assert "src_embed" in capsys.readouterr().err
