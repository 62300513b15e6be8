"""The compiled training step (``runtime.train.StaticStep``) on the CPU.

The step a CUDA device captures once as a graph and replays is the same
body the CPU runs eagerly: the trainer's step over a donated state, static
batch buffers and static outputs.  Here that body, run eagerly, is held

* bitwise to the eager step (``Trainer.make_train_step``) over 8 steps of
  the smoke Llama, on no mesh, a (data 2, model 2) and a (data 1, model 4)
  rank-thread mesh; every other family's case is in
  ``tests/test_torch_train_zoo.py``;
* to the JAX package's ``jax.jit`` trainer's 8-step loss curve at 1e-4
  relative, the limit of ``test_torch_train.py::
  test_eight_step_loss_curve_matches_the_reference_trainer``;
* to its state's identity: every leaf and every placed block keeps its
  storage across steps and restores (a rebinding would leave a replayed
  graph training the old tensors);
* free of host syncs: a step after the first runs under a dispatch mode
  that raises on ``aten._local_scalar_dense`` and ``aten.nonzero``,
  carried into the mesh's rank threads as the cost counter is; a step
  with a ``float(loss)`` inserted raises under it;

and the trainer's and launcher's refusals.  The card's side (captured
against eager steps, a restart with one capture) is in
``tests/test_torch_cuda.py``.
"""
import contextlib
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.models.registry import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.runtime.train import TrainConfig as JaxTrainConfig, Trainer as JaxTrainer
from repro_torch.checkpoint import state_from_jax, store
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_iterator, device_put_batch
from repro_torch.dist import Mesh
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import build_model
from repro_torch.roofline import hlo_stats
from repro_torch.runtime.elastic import replace_state
from repro_torch.runtime.sharding import Placed, unplace_tree
from repro_torch.runtime.train import StaticStep, TrainConfig, Trainer
from repro_torch.tree import tree_leaves

ARCH = "llama3_2_1b"
CURVE_TOL = 1e-4
STEPS = 8
MESHES = {"none": None, "2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model"))}
# what a replayed graph cannot do: read a tensor's value on the host
HOST_SYNCS = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default)


class HostSync(AssertionError):
    """An op of the step read a tensor's value on the host."""


class _NoHostSync(hlo_stats._CountingMode):
    """The cost counter's dispatch mode, which ``Mesh.run`` hands every rank
    thread and autograd its backward thread, raising on a host sync."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in HOST_SYNCS:
            raise HostSync(f"{func} in the training step")
        return super().__torch_dispatch__(func, types, args, kwargs)


@contextlib.contextmanager
def no_host_sync(monkeypatch):
    monkeypatch.setattr(hlo_stats, "rank_scope", lambda counter, rank: _NoHostSync(counter, rank))
    with _NoHostSync(hlo_stats.Counter()):
        yield


@pytest.fixture
def mesh(request):
    spec = MESHES[request.param]
    m = None if spec is None else Mesh(*spec, device="cpu")
    yield m
    if m is not None:
        m.close()


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _trainer(arch, mesh, dtype=None, steps=STEPS, **kw):
    """A CPU trainer of ``arch``'s smoke model under its full config's remat
    policy (the launcher's test's), fp32 if ``dtype`` says so."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat=get_config(arch).remat,
                              **({"dtype": dtype} if dtype else {}))
    return Trainer(build_model(cfg), TrainConfig(steps=steps, lr=1e-3, warmup=2, **kw),
                   mesh=mesh, device="cpu")


def _steps(trainer, state, static: bool, steps: int = STEPS, seq: int = 16):
    """``steps`` steps on the synthetic stream: through the trainer's
    ``StaticStep`` or its eager function; (state, [loss], [lr])."""
    cfg = trainer.model.cfg
    data = batch_iterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=4))
    run = trainer.static_step(state) if static else trainer.make_train_step()
    losses, lrs = [], []
    for _ in range(steps):
        batch = device_put_batch(next(data), "cpu", trainer.mesh)
        if static:
            out = run(batch)
        else:
            state, out = run(state, batch)
        losses.append(out["loss"].clone())
        lrs.append(out["lr"].clone())
    return state, losses, lrs


def assert_static_is_eager(make_trainer):
    """8 steps of the static body and 8 of the eager step from the same
    state: every leaf, loss and learning rate bitwise."""
    got, want = [], []
    for static, into in ((True, got), (False, want)):
        trainer = make_trainer()
        state = trainer.init_state(torch.Generator().manual_seed(0))
        state, losses, lrs = _steps(trainer, state, static)
        into.append((unplace_tree(state), losses, lrs))
    (s1, l1, r1), (s0, l0, r0) = got[0], want[0]
    assert int(s1["step"]) == int(s0["step"]) == STEPS
    for a, b in zip(tree_leaves(s1), tree_leaves(s0)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert all(torch.equal(a, b) for a, b in zip(l1 + r1, l0 + r0))
    return l1


# -- parity ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_curve():
    """(the reference's fp32 smoke Llama state from ``PRNGKey(0)`` as numpy,
    its jitted trainer's 8 losses on 4 x 32 tokens a step)."""
    jmodel = jax_build_model(dataclasses.replace(jax_smoke_config(ARCH), dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    dc = dict(vocab_size=jmodel.cfg.vocab_size, seq_len=32, global_batch=4)
    kw = dict(steps=STEPS, lr=1e-3, warmup=2, log_every=1)
    ref = JaxTrainer(jmodel, JaxTrainConfig(**kw)).fit(
        jax.random.PRNGKey(0), jax_pipeline.batch_iterator(jax_pipeline.DataConfig(**dc)))
    return (jax.tree.map(np.asarray, jax_adamw.init(jparams)),
            [h["loss"] for h in ref["history"]])


@pytest.mark.parametrize("mesh", list(MESHES), indirect=True)
def test_the_static_step_is_the_eager_step_and_the_reference_curve(mesh, reference_curve):
    """The fp32 smoke Llama: bitwise the eager step over 8 steps, and the
    reference's jitted trainer's loss curve from the reference's own init."""
    losses = assert_static_is_eager(lambda: _trainer(ARCH, mesh, "float32"))
    assert all(np.isfinite(float(x)) for x in losses)
    np_state, want = reference_curve
    trainer = _trainer(ARCH, mesh, "float32")
    state = state_from_jax(np_state, trainer.model.cfg, device="cpu")
    if mesh is not None:
        state = replace_state(state, mesh)
    _, got, _ = _steps(trainer, state, static=True, seq=32)
    np.testing.assert_allclose([float(x) for x in got], want, rtol=CURVE_TOL)


# -- identity ----------------------------------------------------------------------------

def _storage(state) -> list:
    return [tuple(b.data_ptr() for b in x.blocks.values()) if isinstance(x, Placed)
            else x.data_ptr() for x in tree_leaves(state)]


@pytest.mark.parametrize("mesh", ["none", "2x2"], indirect=True)
def test_every_leaf_and_block_keeps_its_storage_across_steps_and_a_restore(mesh, tmp_path):
    trainer = _trainer(ARCH, mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    where = _storage(state)
    counter = state["step"]
    store.save(str(tmp_path), 0, unplace_tree(state))
    state, _, _ = _steps(trainer, state, static=True, steps=3)
    assert _storage(state) == where and state["step"] is counter
    assert int(unplace_tree(state)["step"]) == 3
    step, back = trainer.restore(str(tmp_path), state)
    assert step == 0 and back is state and _storage(state) == where
    assert int(unplace_tree(state)["step"]) == 0
    held = trainer.static_step(back)
    assert held is trainer.static_step(state) and held.calls == 3
    if mesh is not None:    # re-placed: new tensors, so a new step (a new capture on a card)
        moved = replace_state(state, mesh)
        assert trainer.static_step(moved) is not held and trainer.static_step(moved).calls == 0


def test_a_step_that_rebinds_a_leaf_raises(monkeypatch):
    trainer = _trainer(ARCH, None)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    real = trainer.make_train_step

    def rebinding():
        fn = real()

        def step(state, batch):
            state, metrics = fn(state, batch)
            state["step"] = state["step"].clone()
            return state, metrics
        return step

    monkeypatch.setattr(trainer, "make_train_step", rebinding)
    with pytest.raises(RuntimeError, match="rebound a leaf"):
        _steps(trainer, state, static=True, steps=1)


# -- no host sync ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "seamless_m4t_medium"])
def test_the_step_makes_no_host_sync(arch, monkeypatch):
    """A step after the first (the one a card captures) of every family the
    launcher trains, each under its full config's remat policy."""
    trainer = _trainer(arch, None)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state, _, _ = _steps(trainer, state, static=True, steps=1)
    with no_host_sync(monkeypatch):
        _steps(trainer, state, static=True, steps=1)


@pytest.mark.parametrize("mesh", ["2x2"], indirect=True)
def test_the_planned_step_makes_no_host_sync_and_a_sync_is_caught(mesh, monkeypatch):
    """On the 2x2 mesh (planned products on the rank threads, AdamW on the
    blocks), then the control: a ``float(loss)`` inside the step raises."""
    trainer = _trainer(ARCH, mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    state, _, _ = _steps(trainer, state, static=True, steps=1)
    with no_host_sync(monkeypatch):
        _steps(trainer, state, static=True, steps=1)
    real = trainer.model.loss

    def syncing(params, batch):
        loss, parts = real(params, batch)
        float(loss)
        return loss, parts

    monkeypatch.setattr(trainer.model, "loss", syncing)
    with no_host_sync(monkeypatch), pytest.raises(HostSync):
        _steps(trainer, state, static=True, steps=1)


# -- refusals ----------------------------------------------------------------------------

def test_capture_is_refused_in_a_process_group_and_on_the_cpu():
    model = build_model(get_smoke_config(ARCH))
    grouped = Mesh((2, 2), ("data", "model"), device="cpu", rank=1)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        Trainer(model, TrainConfig(), mesh=grouped, capture=True)
    assert Trainer(model, TrainConfig(), mesh=grouped).capture is False
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Trainer(model, TrainConfig(), device="cpu", capture=True)
    assert Trainer(model, TrainConfig(), device="cpu").capture is False


@pytest.mark.parametrize("mesh", ["none", "2x2"], indirect=True)
def test_a_batch_of_another_shape_raises(mesh):
    trainer = _trainer(ARCH, mesh)
    step = trainer.static_step(trainer.init_state(torch.Generator().manual_seed(0)))
    assert isinstance(step, StaticStep) and not step.capture
    vocab = trainer.model.cfg.vocab_size
    step(device_put_batch(next(batch_iterator(DataConfig(vocab, 16, 4))), "cpu", mesh))
    with pytest.raises(ValueError, match="laid out as"):
        step(device_put_batch(next(batch_iterator(DataConfig(vocab, 8, 4))), "cpu", mesh))


def test_the_launchers_eager_flag_and_its_default_agree_on_the_cpu(capsys):
    logs = {}
    for flag in ([], ["--eager"]):
        assert launch_train.main(["--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
                                  "--seq", "16", *flag]) == 0
        out = capsys.readouterr().out
        logs[bool(flag)] = re.findall(r"^\[trainer\] step\s+\d+ loss (\S+)", out, re.M)
        assert "[launch] step eager: 0 captures, 0 replays" in out
    assert len(logs[True]) == 4 and logs[True] == logs[False]
