"""Training runtime: the train step and the fault-tolerant outer loop.

Counterpart of ``repro.runtime.train``, on one device or a mesh:

  * the state is fp32 masters and AdamW moments (``optim.adamw``); each
    step casts every master to the type ``model.init`` gave that leaf (the
    reference's ``_dtypes``: norms, the MoE router and xLSTM's gate
    projections fp32, Mamba-2's ``conv_b`` the model's type) inside
    autograd, so the gradients land on the masters in fp32, and every
    projection's three products (forward, dA, dB) run on the Z-order
    kernel (``torch.ops.repro_torch.zorder_matmul``);
  * a state passed to ``fit`` (a checkpoint) takes the same types, read
    from ``model.init`` under ``FakeTensorMode`` (no numbers drawn, no
    memory); the reference's restore branch instead casts every fp32
    master to bf16, norms included;
  * the learning rate follows ``warmup_cosine``; the optimizer updates the
    state in place;
  * each step ends with a device sync on the loss (the reference's
    ``block_until_ready``), so a fault surfaces at the step that made it;
  * checkpoints are written asynchronously every ``ckpt_every`` steps, and
    on a failure (``fail_at_step`` injects one) the loop restores the
    latest complete checkpoint, at most ``max_restarts`` times;
  * a step-time watchdog prints stragglers.

On a mesh of more than one rank (``mesh=``, a ``dist.mesh.Mesh``) the
state is placed (``runtime.sharding.place``): ``step`` replicated, the
masters and both moments by ``models.sharding_rules.param_shardings``, as
the reference's ``init_state`` places them.  A step unplaces the masters
and the batch (placed along the batch axes by ``device_put_batch``), runs
the loss and its gradients under ``use_mesh(mesh)`` and
``planned_matmuls(mesh)`` -- every projection and both of its gradients a
planned product (``dist.api.symmetric_matmul``), each rank's block
product K1 -- then takes each rank's block of every gradient and runs
AdamW on the blocks.  Norms, attention, scans and the loss run on the
gathered tensors, as without a mesh, so the step is the reference's
sharded step up to the order of summation.  Checkpoints hold full arrays
(the unplaced state), so a checkpoint written on a mesh restores into a
trainer without a mesh and, through ``checkpoint.convert``, into the
reference's ``store.restore``, and back; a restore places the arrays on
the trainer's mesh.  In a process group
(``Mesh(..., rank=r)``) every process runs the step on the same global
tensors and holds its own rank's blocks; rank 0 writes the checkpoints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.checkpoint import store
from repro_torch.data.pipeline import device_put_batch
from repro_torch.device import DeviceLike, maybe_sync, resolve_device
from repro_torch.optim import adamw
from repro_torch.plan.context import planned_matmuls
from repro_torch.runtime.elastic import replace_state
from repro_torch.runtime.sharding import Placed, place, unplace, unplace_tree, use_mesh
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    fail_at_step: Optional[int] = None   # fault injection (tests/examples)
    max_restarts: int = 2


class Trainer:
    def __init__(self, model, train_cfg: TrainConfig, mesh=None, device: DeviceLike = None):
        self.model = model
        self.cfg = train_cfg
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and device is None:
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        if self.mesh is not None and self.mesh.device != self.device:
            raise ValueError(f"mesh on {self.mesh.device}, trainer on {self.device}")
        self.opt_cfg = adamw.AdamWConfig()
        self.sched = adamw.warmup_cosine(train_cfg.lr, train_cfg.warmup, train_cfg.steps)
        self._dtypes = None

    # -- state ----------------------------------------------------------------
    def init_state(self, generator: torch.Generator) -> Dict[str, Any]:
        """AdamW state around ``model.init(generator)`` on the device; each
        leaf's type is recorded as its compute type."""
        params = self.model.init(generator, self.device)
        self._dtypes = tree_map(lambda p: p.dtype, params)
        state = adamw.init(params)
        del params
        return state if self.mesh is None else replace_state(state, self.mesh)

    def restore(self, ckpt_dir: str, state: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """The latest checkpoint under ``ckpt_dir`` in ``state``'s structure,
        placed on the trainer's mesh if it has one."""
        step, state = store.restore(ckpt_dir, state)
        return step, state if self.mesh is None else replace_state(state, self.mesh)

    def compute_dtypes(self) -> Any:
        """The tree of types the masters are cast to for a step: those
        ``model.init`` gives each leaf (module docstring)."""
        if self._dtypes is None:
            with FakeTensorMode():
                params = self.model.init(torch.Generator(), "cpu")
            self._dtypes = tree_map(lambda p: p.dtype, params)
        return self._dtypes

    # -- step -----------------------------------------------------------------
    def loss_and_grads(self, master: Any, batch: Dict
                       ) -> Tuple[torch.Tensor, Dict, List[torch.Tensor]]:
        """(loss, the loss's parts, the gradient of every master leaf in
        ``tree_leaves`` order), the masters cast to their compute types
        inside autograd.  A leaf the loss does not reach raises."""
        dtypes = self.compute_dtypes()
        leaves = tree_leaves(master)
        for w in leaves:
            w.requires_grad_(True)
        try:
            params = tree_map(lambda w, t: w.to(t), master, dtypes)
            loss, metrics = self.model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for w in leaves:
                w.requires_grad_(False)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def make_train_step(self) -> Callable:
        mesh = self.mesh

        def train_step(state, batch):
            lr = self.sched(adamw.step_count(state))
            if mesh is None:
                loss, metrics, grads = self.loss_and_grads(state["master"], batch)
            else:
                master = tree_map(unplace, state["master"])
                batch = {k: unplace(v) if isinstance(v, Placed) else v
                         for k, v in batch.items()}
                with use_mesh(mesh), planned_matmuls(mesh):
                    loss, metrics, grads = self.loss_and_grads(master, batch)
                del master
                for i, w in enumerate(tree_leaves(state["master"])):
                    grads[i] = place(grads[i], w.sharding)   # frees the full gradient
            state, opt_metrics = adamw.step(state, grads, lr, self.opt_cfg)
            return state, {"loss": loss, **metrics, **opt_metrics}
        return train_step

    def _save(self, writer: "store.AsyncWriter", step: int, state: Dict[str, Any]) -> None:
        full = unplace_tree(state)   # collective in a process group
        if self.mesh is None or self.mesh.rank in (None, 0):
            writer.save(self.cfg.ckpt_dir, step, full)

    # -- loop -----------------------------------------------------------------
    def fit(self, generator: Optional[torch.Generator],
            data_iter: Iterator[Dict[str, np.ndarray]],
            state: Optional[Dict] = None) -> Dict[str, Any]:
        cfg = self.cfg
        restarts = 0
        start_step = 0
        if state is None:
            state = self.init_state(generator)
        elif self.mesh is not None and not all(
                isinstance(x, Placed) and x.sharding.mesh is self.mesh
                for x in tree_leaves(state)):
            state = replace_state(state, self.mesh)
        if cfg.ckpt_dir and store.latest_step(cfg.ckpt_dir) is not None:
            start_step, state = self.restore(cfg.ckpt_dir, state)
        train_step = self.make_train_step()
        writer = store.AsyncWriter()
        history = []
        step_times = []
        step = start_step
        injected = False
        saved = None

        while step < cfg.steps:
            batch = device_put_batch(next(data_iter), self.device, self.mesh)
            t0 = time.perf_counter()
            try:
                if cfg.fail_at_step == step and not injected:
                    injected = True
                    raise RuntimeError("injected node failure")
                state, metrics = train_step(state, batch)
                maybe_sync(self.device)
            except Exception as e:  # noqa: BLE001 -- restart boundary
                restarts += 1
                if restarts > cfg.max_restarts or not cfg.ckpt_dir:
                    raise
                writer.wait()
                latest = store.latest_step(cfg.ckpt_dir)
                print(f"[trainer] step {step} failed ({e}); "
                      f"restoring step {latest} and continuing")
                step, state = self.restore(cfg.ckpt_dir, state)
                continue
            dt = time.perf_counter() - t0
            step_times.append(dt)
            med = float(np.median(step_times[-20:]))
            if dt > cfg.straggler_factor * med and len(step_times) > 5:
                print(f"[trainer] straggler: step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s)")
            step += 1
            if step % cfg.log_every == 0 or step == cfg.steps:
                loss = float(metrics["loss"])
                history.append({"step": step, "loss": loss, "sec_per_step": dt})
                print(f"[trainer] step {step:5d} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            if cfg.ckpt_dir and step % cfg.ckpt_every == 0:
                self._save(writer, step, state)
                saved = step
        # the reference saves again here; the state an async save of this
        # same step wrote is the one it would write
        if cfg.ckpt_dir and saved != step:
            self._save(writer, step, state)
        writer.wait()
        return {"state": state, "history": history, "restarts": restarts}
