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

The compiled step (``StaticStep``, the counterpart of the reference's
``jax.jit(train_step, donate_argnums=(0,))``): ``fit`` runs every step
through one ``StaticStep`` bound to the state.  The state is donated: the
step writes each of its leaves in place (AdamW's moments, masters and
counter, each placed block), so no leaf changes identity and one CUDA
graph can read and write them at every replay.  The batch goes through
static buffers and the step's outputs are static.  On a CUDA device
(``Trainer(capture=None)``, the default there) the first step runs
eagerly on the capture stream, the second is captured once as a CUDA graph in
its own memory pool and replayed, and every later step replays it: the
host dispatches one graph a step instead of every kernel.  On a mesh of
rank threads the rank streams of every ``Mesh.run``, the planned
backward's on autograd's device thread included, are the graph's
branches.  On the CPU, with ``capture=False`` and in a process group
(not captured yet: ROADMAP queue 1 item 2) the same body runs eagerly.  A
restart restores the checkpoint into the donated state, so the graph is
kept; a state re-placed onto another mesh gets a new step, which captures
again.  A capture that fails raises (``CaptureError``): nothing falls back
to the eager step.  ``graph_report()`` counts the K1 launches and planned
products the replays ran, replays x what the capture recorded (a replay
moves no host counter).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.checkpoint import store
from repro_torch.data.pipeline import device_put_batch
from repro_torch.device import DeviceLike, maybe_sync, resolve_device
from repro_torch.optim import adamw
from repro_torch.kernels.matmul import kernel as k1
from repro_torch.plan.context import planned_matmuls
from repro_torch.plan.lower_dist import executions_snapshot
from repro_torch.runtime.elastic import replace_state
from repro_torch.runtime.sharding import (Placed, place, place_into, unplace, unplace_tree,
                                          use_mesh)
from repro_torch.tree import tree_leaves, tree_map

# where capture in a process group waits (NCCL's collectives captured)
PROCESS_GROUP_CAPTURE = ("capturing a training step in a process group waits for the NCCL run "
                         "on four cards (ROADMAP queue 1 item 2): pass capture=False")


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


class CaptureError(RuntimeError):
    """A training step that could not be captured as a CUDA graph."""


class Trainer:
    """``capture``: ``None`` captures the step on a CUDA device (not in a
    process group); ``True`` asks for capture, which raises
    ``NotImplementedError`` in a process group and ``ValueError`` on the
    CPU; ``False`` runs every step eagerly (module docstring)."""

    def __init__(self, model, train_cfg: TrainConfig, mesh=None, device: DeviceLike = None,
                 capture: Optional[bool] = None):
        self.model = model
        self.cfg = train_cfg
        grouped = mesh is not None and mesh.rank is not None
        if capture and grouped:
            raise NotImplementedError(PROCESS_GROUP_CAPTURE)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and device is None:
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        if self.mesh is not None and self.mesh.device != self.device:
            raise ValueError(f"mesh on {self.mesh.device}, trainer on {self.device}")
        if capture and self.device.type != "cuda":
            raise ValueError(f"capture=True needs a CUDA device, the trainer is on {self.device}")
        self.capture = self.device.type == "cuda" and not grouped if capture is None \
            else bool(capture)
        self.opt_cfg = adamw.AdamWConfig()
        self.sched = adamw.warmup_cosine(train_cfg.lr, train_cfg.warmup, train_cfg.steps)
        self._dtypes = None
        self._static: Optional[StaticStep] = None
        self._captures = 0     # graphs of the steps dropped before ``_static``'s

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
        """(step, state) of the latest checkpoint under ``ckpt_dir``.  A
        state laid out as this trainer lays its own (tensors without a
        mesh, blocks on the trainer's mesh with one) is written in place,
        leaf by leaf and block by block, from host arrays, so a captured
        step goes on reading and writing the same tensors; any other (a
        template from another mesh) gives a new state in its structure,
        placed on the trainer's mesh if it has one."""
        if not self._lays_out(state):
            step, state = store.restore(ckpt_dir, state)
            return step, state if self.mesh is None else replace_state(state, self.mesh)
        step, full = store.restore(ckpt_dir, tree_map(lambda _: None, state))
        with torch.no_grad():
            tree_map(lambda x, f: place_into(x, f) if isinstance(x, Placed) else x.copy_(f),
                     state, full)
        return step, state

    def _lays_out(self, state: Dict[str, Any]) -> bool:
        """Whether ``state`` is laid out as this trainer's (``restore``)."""
        if self.mesh is None:
            return all(torch.is_tensor(x) for x in tree_leaves(state))
        return all(isinstance(x, Placed) and x.sharding.mesh is self.mesh
                   for x in tree_leaves(state))

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
        """The step as a function, ``(state, batch) -> (state, metrics)``,
        run eagerly: the body ``StaticStep`` runs or captures.  Every leaf
        of the state is written in place, so the state returned is the
        state given."""
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

    def static_step(self, state: Dict[str, Any]) -> "StaticStep":
        """The trainer's ``StaticStep`` bound to ``state``: the one it holds
        if that one holds ``state`` (a restore writes into it: the graph is
        kept), else a new one (a state re-placed onto another mesh, say:
        the old graph is dropped and the new step captures again)."""
        if self._static is None or self._static.state is not state:
            if self._static is not None:
                self._captures += self._static.graph is not None
            self._static = None    # the old graph and its pool go first
            self._static = StaticStep(self, state, self.capture)
        return self._static

    def graph_report(self) -> Dict[str, Any]:
        """Kernel and plan accounting of the captured step, as
        ``Server.cache_report()`` / ``plan_report()`` count a server's:
        the graphs captured, the current step's replays, its capture
        seconds, the K1 launches by route and the planned products by
        strategy one replay runs (recorded at capture), and replays x
        those.  The host counters (``kernel.launches``,
        ``lower_dist.executions``) cover the eager steps and the capture;
        this covers the replays."""
        s = self._static
        captured = s is not None and s.graph is not None
        return {"captures": self._captures + captured,
                "replays": s.replays if s else 0,
                "capture_s": s.capture_s if s else None,
                "k1_per_replay": dict(s.k1_routes) if s else {},
                "products_per_replay": dict(s.products) if s else {},
                "k1_replayed": {r: s.replays * n for r, n in s.k1_routes.items()} if s else {},
                "products_replayed": ({k: s.replays * n for k, n in s.products.items()}
                                      if s else {})}

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
        train_step = self.static_step(state)
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
                metrics = train_step(batch)
                maybe_sync(self.device)
            except CaptureError:
                raise
            except Exception as e:  # noqa: BLE001 -- restart boundary
                restarts += 1
                if restarts > cfg.max_restarts or not cfg.ckpt_dir:
                    raise
                writer.wait()
                latest = store.latest_step(cfg.ckpt_dir)
                print(f"[trainer] step {step} failed ({e}); "
                      f"restoring step {latest} and continuing")
                step, state = self.restore(cfg.ckpt_dir, state)   # in place
                train_step = self.static_step(state)
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


class StaticStep:
    """One trainer's step bound to one state: the port's
    ``jax.jit(train_step, donate_argnums=(0,))`` (module docstring).

    ``state`` is donated: its leaves are the buffers every call reads and
    writes in place, and a body that rebinds one raises.  Each call copies
    ``batch`` into static buffers, one per key, made at the first call
    (placed as the batch is; later calls copy block by block, and a batch of
    another shape, type or placement raises ``ValueError``), and returns the
    step's outputs (loss, the loss's parts, ``grad_norm``, ``lr``), which the
    next call overwrites: read or clone them first.  With ``capture`` the
    first call runs the body eagerly on the capture stream, which makes what
    a capture may not (cuBLAS's workspace, K1's split-K arrays, the rank
    streams and plans of a mesh); the second captures the body once on that
    stream (``torch.cuda.graph``, a memory pool of its own, K1's split-K
    array prepared first) and replays it; later calls replay it.  Without,
    every call runs the body eagerly on the caller's stream."""

    def __init__(self, trainer: Trainer, state: Dict[str, Any], capture: bool):
        self.state = state
        self.capture = capture
        self.device = trainer.device
        # weak: the trainer holds this step, and a dropped trainer frees its
        # graph, pool and state at once, not at the next cycle collection
        self._trainer = weakref.ref(trainer)
        self._ids = _leaf_ids(state)
        self.batch: Optional[Dict[str, Any]] = None
        self.out: Optional[Dict[str, torch.Tensor]] = None
        self.calls = 0
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.replays = 0
        self.capture_s: Optional[float] = None
        self.k1_routes: Dict[str, int] = {}     # K1 launches by route a replay runs
        self.products: Dict[str, int] = {}      # planned products by strategy a replay runs
        self._capture_ctx = None                 # the warm step's torch.cuda.graph

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        self._load(batch)
        if self.capture and not self.calls:
            self._warm()
        elif self.capture:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.replays += 1
        else:
            self.out = self._body()
        self.calls += 1
        return self.out

    def _body(self) -> Dict[str, torch.Tensor]:
        state, metrics = self._trainer().make_train_step()(self.state, self.batch)
        if state is not self.state or _leaf_ids(state) != self._ids:
            raise RuntimeError("the training step rebound a leaf of its state: a captured "
                               "step would go on training the old tensors")
        return metrics

    def _load(self, batch: Dict[str, Any]) -> None:
        if self.batch is None:
            self.batch = {k: _copied(v) for k, v in batch.items()}
            return
        want = {k: _layout(v) for k, v in self.batch.items()}
        got = {k: _layout(v) for k, v in batch.items()}
        if got != want:
            raise ValueError(f"a batch laid out as {got} for a step whose buffers are {want}")
        with torch.no_grad():
            for k, v in batch.items():
                buf = self.batch[k]
                if isinstance(buf, Placed):
                    for r in buf.distinct_ranks():
                        buf[r].copy_(v[r])
                else:
                    buf.copy_(v)

    def _warm(self) -> None:
        """The first step, eagerly, on the stream the capture will use:
        ``torch.cuda.graph``'s default capture stream, which every capture
        in the process shares (serving's too), so the steps share its
        cuBLAS workspace rather than each leaving one on a stream of its
        own."""
        with torch.cuda.device(self.device):
            self._capture_ctx = torch.cuda.graph(torch.cuda.CUDAGraph())
        stream = self._capture_ctx.capture_stream
        caller = torch.cuda.current_stream(self.device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            self.out = self._body()
        caller.wait_stream(stream)

    def _capture(self) -> None:
        routes, plans = dict(k1.launches_by_route), executions_snapshot()
        capture = self._capture_ctx
        k1.prepare_capture_stream(capture.capture_stream)
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        try:
            with capture:
                out = self._body()
        except Exception as e:  # noqa: BLE001 -- re-raised as what it is
            raise CaptureError(f"the training step could not be captured: {e}") from e
        self.capture_s = time.perf_counter() - t0
        self.graph, self.out = capture.cuda_graph, out
        self._capture_ctx = None
        self.k1_routes = _moved(routes, k1.launches_by_route)
        self.products = _moved(plans, executions_snapshot())


def _leaf_ids(state: Dict[str, Any]) -> List:
    """The identity of every leaf of ``state`` (a placed leaf's: its blocks')."""
    return [tuple(id(b) for b in x.blocks.values()) if isinstance(x, Placed) else id(x)
            for x in tree_leaves(state)]


def _layout(x) -> tuple:
    if isinstance(x, Placed):
        return (tuple(x.shape), x.dtype, x.sharding.spec, id(x.sharding.mesh))
    return (tuple(x.shape), x.dtype, x.device)


def _copied(x):
    """A batch entry in tensors of its own (a placed one's replicas one
    tensor, as ``place`` makes them)."""
    if not isinstance(x, Placed):
        return x.detach().clone()
    fresh: Dict[int, torch.Tensor] = {}
    for b in x.blocks.values():
        if id(b) not in fresh:
            fresh[id(b)] = b.detach().clone()
    return Placed({r: fresh[id(b)] for r, b in x.blocks.items()}, x.sharding,
                  tuple(x.shape), x.dtype)


def _moved(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
