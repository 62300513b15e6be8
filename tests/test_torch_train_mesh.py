"""Sharded training on the CPU: the port's trainer on a (data 2, model 2)
rank-thread mesh against the same trainer without a mesh and against the
JAX package's trainer.

On a mesh the state is placed (``runtime.sharding``) and every projection
and both of its gradients are planned products (``dist.api``), the rest of
the step runs on the gathered tensors: the losses, every gradient leaf and
the updated masters agree with ``mesh=None`` to 1e-5 relative (L2 per
leaf; fp32 on both sides, the order of sums differs; zamba2's ``A_log``
gradients 1e-4, as in ``test_torch_train_zoo.py``), and Llama's 8-step
curve with the reference trainer's to 1e-4, the limit of
``test_torch_train.py::test_eight_step_loss_curve_matches_the_reference_trainer``.
A recompute under ``remat`` plans its products again, on whichever thread
runs the backward.  Checkpoints hold full arrays and cross the mesh, the
unsharded trainer and the reference bitwise; an elastic restart continues
the unbroken curve.
"""
import dataclasses
import importlib
import threading

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.models.registry import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.runtime.train import TrainConfig as JaxTrainConfig, Trainer as JaxTrainer
from repro_torch.checkpoint import state_from_jax, state_to_jax, store
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_iterator, device_put_batch, synth_batch
from repro_torch.dist import Mesh
from repro_torch.kernels.matmul import ops
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import build_model
from repro_torch.models.sharding_rules import param_shardings
from repro_torch.optim import adamw
from repro_torch.plan import planned_matmuls
from repro_torch.runtime import elastic
from repro_torch.runtime.sharding import Placed, unplace, unplace_tree, use_mesh
from repro_torch.runtime.train import TrainConfig, Trainer
from repro_torch.tree import tree_leaves, tree_map, tree_paths

lower_dist = importlib.import_module("repro_torch.plan.lower_dist")

ARCH = "llama3_2_1b"
TOL = 1e-5
# zamba2's ``A_log`` gradients cancel: fp32 lands 1e-5 to 3e-5 off fp64 in
# either package, so any change in the order of sums moves them that far
# (``test_torch_train_zoo.py``'s ``A_LOG_TOL``)
A_LOG_TOL = 1e-4
CURVE_TOL = 1e-4
BATCH, SEQ, SRC = 4, 16, 8


def _rel_l2(a, b) -> float:
    a = np.asarray(a.detach().double() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.detach().double() if torch.is_tensor(b) else b, np.float64)
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def mesh():
    m = Mesh((2, 2), ("data", "model"), device="cpu")
    yield m
    m.close()


def _fp32(arch, **kw):
    return build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw))


def _batch(cfg, step, mesh=None):
    """Tokens from the synthetic pipeline (placed on ``mesh`` if given); the
    encoder-decoder's source frames from numpy seed ``step``, unplaced."""
    nb = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
                     step)
    batch = device_put_batch(nb, "cpu", mesh)
    if cfg.family == "audio":
        rng = np.random.default_rng(step)
        batch["src_embed"] = torch.from_numpy(
            rng.standard_normal((BATCH, SRC, cfg.d_model), dtype=np.float32))
    return batch


def _rank_thread_products(monkeypatch):
    """Counts of the plain version's products by thread while
    ``counts["on"]``: in rank threads of a mesh, or anywhere else (a
    product run locally)."""
    counts = {"rank": 0, "local": 0, "on": True}
    real = ops.matmul_ref

    def counted(*a, **k):
        if counts["on"]:
            name = threading.current_thread().name
            counts["rank" if name.startswith("mesh-rank") else "local"] += 1
        return real(*a, **k)

    monkeypatch.setattr(ops, "matmul_ref", counted)
    return counts


@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_on_a_mesh_match_the_unsharded_trainer(mesh, arch, monkeypatch):
    model = _fp32(arch)
    tc = TrainConfig(steps=2, lr=1e-3, warmup=1)
    plain, sharded = Trainer(model, tc, device="cpu"), Trainer(model, tc, mesh=mesh)
    s0 = plain.init_state(torch.Generator().manual_seed(0))
    s1 = sharded.init_state(torch.Generator().manual_seed(0))
    assert all(isinstance(x, Placed) for x in tree_leaves(s1))
    step0, step1 = plain.make_train_step(), sharded.make_train_step()
    counts = _rank_thread_products(monkeypatch)
    lower_dist.reset_executions()
    for step in range(2):
        b0, b1 = _batch(model.cfg, step), _batch(model.cfg, step, mesh)
        counts["on"] = False
        loss0, _, g0 = plain.loss_and_grads(s0["master"], b0)
        s0, m0 = step0(s0, b0)
        counts["on"] = True
        master = tree_map(unplace, s1["master"])
        with use_mesh(mesh), planned_matmuls(mesh):
            loss1, _, g1 = sharded.loss_and_grads(
                master, {k: unplace(v) if isinstance(v, Placed) else v for k, v in b1.items()})
        assert _rel_l2(loss1, loss0) < TOL
        for (path, _), a, b in zip(tree_paths(s0["master"]), g1, g0):
            assert _rel_l2(a, b) < (A_LOG_TOL if path[-1] == "A_log" else TOL), (step, path)
        s1, m1 = step1(s1, b1)
        assert _rel_l2(m1["loss"], m0["loss"]) < TOL
        assert _rel_l2(m1["grad_norm"], m0["grad_norm"]) < TOL
        for (path, w0), w1 in zip(tree_paths(s0["master"]), tree_leaves(s1["master"])):
            assert _rel_l2(unplace(w1), w0) < TOL, (step, path)
    assert int(adamw.step_count(s1)) == 2
    # every product of the sharded steps ran in the mesh's rank threads but
    # the unembedding's, which is never planned (the reference leaves it to
    # XLA): its forward, dA and dB (fp32) in each of the 2 x 2 sharded
    # loss-and-gradient passes
    assert counts["local"] == 2 * 2 * 3 and counts["rank"] > 0
    assert sum(lower_dist.executions.values()) > 0


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_a_recompute_plans_again_on_the_backward_thread(mesh, remat, monkeypatch):
    """zamba2's Mamba layers under remat: the forward's planned products run
    again in the backward, planned, though the backward runs in a thread
    where the plan scope was never entered (as autograd's device thread on
    CUDA): executions a step = forward + recompute + dA + dB."""
    model = _fp32("zamba2_2_7b", remat=remat)
    trainer = Trainer(model, TrainConfig(), mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    master = tree_map(unplace, state["master"])
    batch = {k: unplace(v) for k, v in _batch(model.cfg, 0, mesh).items()}
    ref = Trainer(_fp32("zamba2_2_7b"), TrainConfig(), device="cpu").loss_and_grads(
        tree_map(lambda t: t.clone(), master), batch)
    counts = _rank_thread_products(monkeypatch)
    dtypes = trainer.compute_dtypes()
    leaves = tree_leaves(master)
    for w in leaves:
        w.requires_grad_(True)
    lower_dist.reset_executions()
    with use_mesh(mesh), planned_matmuls(mesh):
        params = tree_map(lambda w, t: w.to(t), master, dtypes)
        loss, _ = model.loss(params, batch)
    forward = sum(lower_dist.executions.values())
    out = {}
    t = threading.Thread(target=lambda: out.update(g=torch.autograd.grad(loss, leaves)))
    t.start()
    t.join(120)
    assert not t.is_alive() and "g" in out
    # the Mamba layers run under remat, their in and out projections
    # recomputed (the shared attention blocks are not wrapped)
    total = sum(lower_dist.executions.values())
    assert total == 3 * forward + 2 * model.cfg.num_layers, (forward, total)
    assert counts["local"] == 3     # the unembedding's product, dA and dB, unplanned
    assert _rel_l2(loss, ref[0]) < TOL
    for (path, _), g, want in zip(tree_paths(master), out["g"], ref[2]):
        assert _rel_l2(g, want) < (A_LOG_TOL if path[-1] == "A_log" else TOL), path


def test_the_eight_step_curve_on_a_mesh_matches_the_reference_trainer(mesh):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = _fp32(ARCH)
    dc = dict(vocab_size=model.cfg.vocab_size, seq_len=32, global_batch=4)
    kw = dict(steps=8, lr=1e-3, warmup=2, log_every=1)
    ref = JaxTrainer(jmodel, JaxTrainConfig(**kw)).fit(
        jax.random.PRNGKey(0), jax_pipeline.batch_iterator(jax_pipeline.DataConfig(**dc)))
    state = state_from_jax(jax.tree.map(np.asarray, jax_adamw.init(jparams)), model.cfg,
                           device="cpu")
    out = Trainer(model, TrainConfig(**kw), mesh=mesh).fit(
        None, batch_iterator(DataConfig(**dc)), state=state)
    want = [h["loss"] for h in ref["history"]]
    got = [h["loss"] for h in out["history"]]
    assert len(got) == 8
    np.testing.assert_allclose(got, want, rtol=CURVE_TOL)
    assert all(isinstance(x, Placed) and x.sharding.mesh is mesh
               for x in tree_leaves(out["state"]))


def test_placed_state_is_the_size_of_the_unplaced(mesh):
    model = build_model(get_smoke_config(ARCH))
    state = Trainer(model, TrainConfig(), mesh=mesh).init_state(
        torch.Generator().manual_seed(0))
    full = adamw.init(model.init(torch.Generator().manual_seed(0), "cpu"))
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    distinct = [b for x in tree_leaves(state) for b in x.distinct()]
    assert nbytes(distinct) == nbytes(tree_leaves(full))
    shardings = param_shardings(full["master"], mesh)
    for x, want in zip(tree_leaves(state["master"]), tree_leaves(shardings)):
        assert x.sharding.spec == want.spec
    assert state["master"]["layers"][0]["attn"]["wq"].sharding.spec == (None, "model")
    assert state["step"].sharding.spec == ()


# -- checkpoints -------------------------------------------------------------------------------

def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().ravel()


def _fit(tmp_path, mesh, steps, state=None, **kw):
    """The bf16 smoke Llama trained to ``steps`` with a checkpoint every 2,
    from the latest checkpoint under ``tmp_path`` if there is one (the
    batches from that step on)."""
    model = build_model(get_smoke_config(ARCH))
    dc = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=16, global_batch=4)
    tc = TrainConfig(steps=steps, lr=1e-3, warmup=1, ckpt_dir=str(tmp_path), ckpt_every=2,
                     log_every=1, **kw)
    start = store.latest_step(str(tmp_path)) or 0
    return Trainer(model, tc, mesh=mesh, device="cpu").fit(
        torch.Generator().manual_seed(0), batch_iterator(dc, start_step=start), state=state)


@pytest.mark.parametrize("writer", ["mesh", "none"])
def test_a_checkpoint_crosses_between_mesh_and_no_mesh_bitwise(tmp_path, mesh, writer):
    out = _fit(tmp_path, mesh if writer == "mesh" else None, 2)
    written = unplace_tree(out["state"])
    reader = Trainer(build_model(get_smoke_config(ARCH)), TrainConfig(),
                     mesh=None if writer == "mesh" else mesh, device="cpu")
    step, back = reader.restore(str(tmp_path), out["state"])
    assert step == 2
    if writer == "none":
        assert all(isinstance(x, Placed) for x in tree_leaves(back))
    for a, b in zip(tree_leaves(written), tree_leaves(back)):
        b = unplace(b) if isinstance(b, Placed) else b
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_a_mesh_checkpoint_crosses_to_the_reference_and_back_bitwise(tmp_path, mesh):
    out = _fit(tmp_path / "port", mesh, 2)
    full = unplace_tree(out["state"])
    jtree = state_to_jax(full)
    store.save(str(tmp_path / "x"), 2, jtree)
    template = jax_adamw.init(jax_build_model(jax_smoke_config(ARCH)).init(
        jax.random.PRNGKey(0)))
    step, got = jax_store.restore(str(tmp_path / "x"), template)
    assert step == 2
    flat_j = {"//".join(str(getattr(e, "key", e)) for e in p): leaf
              for p, leaf in jax.tree_util.tree_flatten_with_path(got)[0]}
    for path, leaf in tree_paths(jtree):
        want = flat_j["//".join(map(str, path))]
        assert np.array_equal(_bits(leaf), np.asarray(want).view(
            np.int16 if leaf.dtype == torch.bfloat16 else np.asarray(want).dtype).ravel())
    # and back: the reference writes, a trainer on the mesh restores
    jax_store.save(str(tmp_path / "y"), 5, got)
    _, np_state = store.restore(str(tmp_path / "y"), state_to_jax(full))
    placed = elastic.replace_state(state_from_jax(np_state, get_smoke_config(ARCH),
                                                  device="cpu"), mesh)
    for a, b in zip(tree_leaves(full), tree_leaves(unplace_tree(placed))):
        assert np.array_equal(_bits(a), _bits(b))


def test_a_restart_on_a_mesh_follows_the_unsharded_restart(tmp_path, mesh, capsys):
    """The trainer's own restart path on placed state: a failure at step 3
    restores step 2's checkpoint onto the mesh; the curve (the data stream
    runs on across the restart, as in the reference) is the unsharded
    trainer's through the same failure."""
    sharded = _fit(tmp_path / "a", mesh, 6, fail_at_step=3)
    assert sharded["restarts"] == 1
    assert "step 3 failed (injected node failure); restoring step 2" in capsys.readouterr().out
    plain = _fit(tmp_path / "b", None, 6, fail_at_step=3)
    assert [h["step"] for h in sharded["history"]] == [1, 2, 3, 3, 4, 5, 6]
    np.testing.assert_allclose([h["loss"] for h in sharded["history"]],
                               [h["loss"] for h in plain["history"]], rtol=CURVE_TOL)
    assert all(x.sharding.mesh is mesh for x in tree_leaves(sharded["state"]))


def test_an_elastic_restart_continues_the_unbroken_curve(tmp_path):
    """Two steps on (pod 2, data 1, model 2) with a checkpoint, a failure at
    the third, the pod dropped, the state re-placed onto (data 1, model 2),
    two more steps: the four losses are four unbroken steps without a mesh."""
    pods = elastic.make_mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    first = _fit(tmp_path, pods, 2)
    with pytest.raises(RuntimeError, match="injected node failure"):
        _fit(tmp_path, pods, 4, fail_at_step=2, max_restarts=0)
    survivors = elastic.shrink_after_failure(pods)
    assert survivors.axis_names == ("data", "model") and survivors.size == 2
    step, full = store.restore(str(tmp_path), first["state"])
    state = elastic.replace_state(full, survivors)
    assert step == 2 and state["master"]["layers"][0]["attn"]["wq"].sharding.mesh is survivors
    rest = _fit(tmp_path, survivors, 4, state=state)
    unbroken = _fit(tmp_path / "plain", None, 4)
    got = [h["loss"] for h in first["history"] + rest["history"]]
    np.testing.assert_allclose(got, [h["loss"] for h in unbroken["history"]], rtol=CURVE_TOL)
    pods.close()
    survivors.close()


# -- the launcher ------------------------------------------------------------------------------

def test_the_launcher_trains_on_a_2x2_rank_mesh(capsys):
    assert launch_train.main(["--tp", "2", "--ranks", "4", "--smoke", "--device", "cpu",
                              "--steps", "4", "--batch", "4", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in out and "[launch] done: loss" in out
    assert "[launch] planned products: {" in out and "ignored" not in out
    assert launch_train.build_mesh(4, 1) is None
    m = launch_train.build_mesh(8, 4, "cpu")
    assert m.shape == {"data": 1, "model": 4}
