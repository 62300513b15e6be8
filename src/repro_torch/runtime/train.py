"""Training runtime: the train step and the fault-tolerant outer loop.

Counterpart of ``repro.runtime.train``, on one device:

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

A mesh of more than one rank raises: sharded training (parameter and
optimizer shards, the planned products' backward) is ROADMAP queue 1,
item 8.
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
        if mesh is not None and getattr(mesh, "size", 1) > 1:
            raise NotImplementedError(
                "sharded training is not ported yet (ROADMAP queue 1, item 8): "
                "train on one device with mesh=None")
        self.model = model
        self.cfg = train_cfg
        self.device = resolve_device(device)
        self.opt_cfg = adamw.AdamWConfig()
        self.sched = adamw.warmup_cosine(train_cfg.lr, train_cfg.warmup, train_cfg.steps)
        self._dtypes = None

    # -- state ----------------------------------------------------------------
    def init_state(self, generator: torch.Generator) -> Dict[str, Any]:
        """AdamW state around ``model.init(generator)`` on the device; each
        leaf's type is recorded as its compute type."""
        params = self.model.init(generator, self.device)
        self._dtypes = tree_map(lambda p: p.dtype, params)
        return adamw.init(params)

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
        def train_step(state, batch):
            lr = self.sched(state["step"])
            loss, metrics, grads = self.loss_and_grads(state["master"], batch)
            state, opt_metrics = adamw.step(state, grads, lr, self.opt_cfg)
            return state, {"loss": loss, **metrics, **opt_metrics}
        return train_step

    # -- loop -----------------------------------------------------------------
    def fit(self, generator: Optional[torch.Generator],
            data_iter: Iterator[Dict[str, np.ndarray]],
            state: Optional[Dict] = None) -> Dict[str, Any]:
        cfg = self.cfg
        restarts = 0
        start_step = 0
        if state is None:
            state = self.init_state(generator)
        if cfg.ckpt_dir and store.latest_step(cfg.ckpt_dir) is not None:
            start_step, state = store.restore(cfg.ckpt_dir, state)
        train_step = self.make_train_step()
        writer = store.AsyncWriter()
        history = []
        step_times = []
        step = start_step
        injected = False

        while step < cfg.steps:
            batch = device_put_batch(next(data_iter), self.device)
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
                step, state = store.restore(cfg.ckpt_dir, state)
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
                writer.save(cfg.ckpt_dir, step, state)
        writer.wait()
        # the reference saves again here; the state an async save of this
        # same step wrote is the one it would write
        if cfg.ckpt_dir and writer.last_step != step:
            store.save(cfg.ckpt_dir, step, state)
        return {"state": state, "history": history, "restarts": restarts}
