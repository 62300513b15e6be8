"""AdamW over the port's parameter tree: fp32 master weights and moments,
global-norm clipping.

Counterpart of ``repro.optim.adamw`` (no kernel there: plain array code
under ``jit``).  The state mirrors the param tree (a list of per-layer
dicts, as ``DecoderLM.init`` makes it).  Unlike the reference, ``step``
updates the state's tensors in place (no second copy of the 12 bytes a
parameter of master, m and v) and returns the same dict; each leaf's
update is the reference's ``upd``, op for op, in fp32.  The step counter,
the learning rate and the bias corrections stay 0-d tensors on the
state's device, so a step never waits for the card, and the counter is
written into its own tensor (``copy_``): no leaf of the state changes
identity across a step, so a step captured as a CUDA graph
(``runtime.train.StaticStep``) reads the advanced counter at its next
replay.

A placed state (``runtime.sharding.Placed`` leaves, the trainer's on a
mesh) steps block by block: each distinct block of a leaf once (replicas
share one tensor on one controller), with the matching block of its
gradient, the reference's arithmetic element by element.  Its global norm
sums each distinct block's squares once; in a process group each process
sums the blocks it owns (replica 0 of each) and the sums are all-reduced.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.runtime.sharding import Placed, unplace
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params: Any) -> Dict[str, Any]:
    """fp32 copies of ``params`` as masters, zero moments, step 0 (int32 on
    the params' device)."""
    device = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32; a placed leaf's
    distinct blocks counted once each (module docstring)."""
    leaves = tree_leaves(tree)
    if not any(isinstance(g, Placed) for g in leaves):
        sq = [g.detach().float().square().sum() for g in leaves]
        return torch.stack(sq).sum().sqrt()
    sq, mesh = [], None
    for g in leaves:
        mesh = g.sharding.mesh
        sq += [g[r].detach().float().square().sum() for r in g.owned_ranks()]
    total = torch.stack(sq).sum() if sq else torch.zeros((), device=mesh.device)
    if mesh.rank is not None:
        import torch.distributed as dist

        dist.all_reduce(total)
    return total.sqrt()


def _blocks(state: Dict[str, Any], grads: list):
    """(g, m, v, w) per distinct block of every leaf, in leaf order."""
    for g, m, v, w in zip(grads, tree_leaves(state["m"]), tree_leaves(state["v"]),
                          tree_leaves(state["master"])):
        if isinstance(w, Placed):
            for r in w.distinct_ranks():
                yield g[r], m[r], v[r], w[r]
        else:
            yield g, m, v, w


@torch.no_grad()
def step(state: Dict[str, Any], grads: Any, lr: torch.Tensor, cfg: AdamWConfig
         ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place (module docstring); ``grads`` is a tree of
    the masters' structure or the list of their leaves in ``tree_leaves``
    order.  Returns (state, {"grad_norm": the norm before clipping, "lr"})."""
    flat_g = tree_leaves(grads)
    flat_w = tree_leaves(state["master"])
    if len(flat_g) != len(flat_w):
        raise ValueError(f"{len(flat_g)} gradients for {len(flat_w)} master leaves")
    gnorm = global_norm(flat_g)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    t = step_count(state) + 1
    b1c = 1.0 - cfg.b1 ** t.float()
    b2c = 1.0 - cfg.b2 ** t.float()
    for g, m, v, w in _blocks(state, flat_g):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        w.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * w))
    counter = state["step"]
    for c in counter.distinct() if isinstance(counter, Placed) else (counter,):
        c.copy_(t)
    return state, {"grad_norm": gnorm, "lr": lr}


def step_count(state: Dict[str, Any]) -> torch.Tensor:
    """The state's step, a 0-d int32 tensor (placed or not)."""
    s = state["step"]
    return unplace(s) if isinstance(s, Placed) else s


def params_from_state(state: Dict[str, Any], like: Any) -> Any:
    """The masters cast to the types of ``like``'s leaves."""
    return tree_map(lambda w, p: w.to(p.dtype), state["master"], like)


def warmup_cosine(base_lr: float, warmup: int, total: int, floor: float = 0.1
                  ) -> Callable[[Union[int, torch.Tensor]], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine down
    to ``floor`` x ``base_lr`` at ``total``; the step (an int or a tensor)
    in fp32, the rate a 0-d fp32 tensor on the step's device."""
    def sched(step: Union[int, torch.Tensor]) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return sched
