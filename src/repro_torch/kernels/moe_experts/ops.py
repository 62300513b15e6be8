"""Routed MoE experts: the grouped kernel on CUDA tensors, the plain version
on CPU tensors.

``layers/moe.py``'s ``moe`` sends a call here when ``takes`` accepts the
tensors (CUDA bf16, no grad, outside any dispatch mode); every other call,
a counter's or a fake run's included, keeps the dense one-hot route, the
reference's form.  There is no autograd formula: ``takes`` refuses
operands that require grad.

With ``repro_torch.obs`` tracing enabled, each call counts in
``kernel.moe_experts.launches{route}`` (``grouped`` for the kernel,
``plain`` for the CPU version) and is a ``kernel.moe_experts`` span around
the launch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs

from . import kernel


def moe_experts(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, expert_idx: torch.Tensor, gates: torch.Tensor,
                group: int, cap: int) -> torch.Tensor:
    """The routed experts of x (T, d) from its routing: each token's top-k
    experts ``expert_idx`` (T, k) and ``gates`` (T, k), in routing groups of
    ``group`` tokens with capacity ``cap`` -> y (T, d) in x's type: each
    kept pair's SwiGLU, its products rounded to x's type, summed over each
    token's choices in fp32."""
    if not obs.enabled():
        return _run(x, w_gate, w_up, w_down, expert_idx, gates, group, cap)
    route = "plain" if x.device.type == "cpu" else "grouped"
    obs.counter("kernel.moe_experts.launches").inc(route=route)
    e, d, ff = w_gate.shape
    with obs.span("kernel.moe_experts", t=x.shape[0], k=expert_idx.shape[1], e=e, d=d, ff=ff,
                  route=route):
        return _run(x, w_gate, w_up, w_down, expert_idx, gates, group, cap)


def combine(ye: torch.Tensor, pos: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """y_t = sum over t's kept choices c, in choice order, of gates[t, c] *
    ye[pos[t, c]] in fp32 (the kernel's order: a product, then a sum)."""
    y = torch.zeros((pos.shape[0], ye.shape[1]), dtype=torch.float32, device=ye.device)
    for c in range(pos.shape[1]):
        q = pos[:, c].long()
        v = ye[q.clamp(min=0)].float() * gates[:, c, None]
        y = torch.where(q[:, None] >= 0, y + v, y)
    return y


def plain(x, w_gate, w_up, w_down, expert_idx, gates, group, cap):
    """The plain version: the pair list of ``layers.moe.pairs``, each
    expert's pairs through its SwiGLU (the dense route's ``expert_ffn``
    arithmetic: each product rounded to x's type, SiLU and product in
    fp32), then ``combine``.  Reads the offsets on the host, so it is for
    tests and checks, never a captured step."""
    from repro_torch.layers.moe import pairs    # that module routes calls here

    t, k = expert_idx.shape
    shape = (t // group, group, k)
    rows, offsets, pos, gates = pairs(expert_idx.reshape(shape), gates.reshape(shape),
                                      w_gate.shape[0], cap)
    ye = x.new_zeros((rows.shape[0], x.shape[1]))
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if lo == hi:
            continue
        xe = x[rows[lo:hi].long()]
        gate = (xe @ w_gate[e]).float()
        up = (xe @ w_up[e]).float()
        ye[lo:hi] = (F.silu(gate) * up).to(x.dtype) @ w_down[e]
    return combine(ye, pos, gates).to(x.dtype)


def _run(x, w_gate, w_up, w_down, expert_idx, gates, group, cap):
    if x.device.type == "cpu":
        return plain(x, w_gate, w_up, w_down, expert_idx, gates, group, cap)
    return kernel.moe_experts(x, w_gate, w_up, w_down, expert_idx, gates, group, cap)
