"""Mixture-of-Experts: top-k token-choice routing with capacity (GShard
dispatch/combine) and optional always-on shared experts (deepseek-moe).

Counterpart of ``repro.layers.moe``, with the same semantics: tokens route
in groups of ``min(moe_group_size, S)`` (``S % g`` must be 0), the router
runs in fp32, gates are the top-k softmax probabilities renormalised (or,
with ``moe_renormalize`` off, as they are: DeepSeek-V2), each choice takes
the next free slot of its expert in the group (a per-choice cumulative
count) and tokens past the capacity are dropped.
The Switch load-balancing loss comes back beside the output.  An input of
more than ``DISPATCH_TOKENS`` tokens routes its groups in slices of that
many, which bounds the dispatched expert products' transient memory.

Two routes for the routed experts (SiLU(gate) * up, then down, on the
stacked ``(E, d, ff)`` / ``(E, ff, d)`` weights), one routing:

* **routed**: where ``kernels.moe_experts.takes`` accepts the call (real
  CUDA bf16 tensors, no grad, no dispatch mode), the grouped kernel
  ``kernels/moe_experts`` turns the kept choices into a pair list (token
  rows sorted by expert, the expert offsets, each choice's place or -1;
  ``pairs`` is its plain version) and runs each kept pair once, reading
  each chosen expert's weights once.
* **dense**: every other call (the CPU, grad, a counter or a fake run)
  keeps the reference's form: one-hot dispatch and combine tensors and
  ``torch.einsum`` products (``expert_ffn``), as the reference computes
  them with ``jnp.einsum`` outside any Pallas kernel; every expert runs on
  every capacity slot of every group.

Both round each product to x's type before the fp32 SiLU, product and
combine; they differ only in the combine's fp32 summation order.
``layer.moe.calls{route}`` counts each call's route.  The shared experts
are an ``mlp`` and so go through ``linear`` and the Z-order kernel.

The layer can be captured in a CUDA graph: static shapes and no host
synchronisation.  The one-hots are comparisons with an ``arange`` (not
``F.one_hot``, which checks its indices on the host), and the top-k comes
from a stable descending sort, so equal probabilities pick the lower
expert index first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
order among ties).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import moe_experts
from repro_torch.models.config import ModelConfig
from .mlp import mlp, mlp_params

Params = Dict[str, torch.Tensor]


def moe_params(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device) -> Params:
    """The reference's distributions: router N(0, 0.02) in fp32, stacked
    expert weights N(0, 1/d_in); shared experts one ``mlp`` of width
    ``moe_d_ff * num_shared_experts``."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def normal(shape, std, out_dtype):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std
        return w.to(device=device, dtype=out_dtype)

    p: Params = {
        "router": normal((d, e), 0.02, torch.float32),
        "w_gate": normal((e, d, ff), d ** -0.5, dtype),
        "w_up": normal((e, d, ff), d ** -0.5, dtype),
        "w_down": normal((e, ff, d), ff ** -0.5, dtype),
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_params(generator, d, ff * cfg.num_shared_experts, dtype, device)
    return p


def _capacity(group: int, num_experts: int, top_k: int, factor: float) -> int:
    cap = int(group * top_k / num_experts * factor)
    return max(4, (cap + 3) // 4 * 4)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of int ``idx`` over ``n`` classes, on the device."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last dim and their indices,
    largest first and equal values in index order, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its dispatched slots: xe (N, E, C, d) ->
    (N, E, C, d) in xe's type; each product's output rounded to xe's type
    before the fp32 SiLU and product, as the reference casts them."""
    gate = torch.einsum("necd,edf->necf", xe, p["w_gate"]).float()
    up = torch.einsum("necd,edf->necf", xe, p["w_up"]).float()
    h = F.silu(gate) * up
    return torch.einsum("necf,efd->necd", h.to(xe.dtype), p["w_down"])


# the tokens whose routing and expert products run at once: a larger input
# runs its routing groups in slices of this many tokens (groups never
# share tokens, so the answer is the one pass's), which bounds the dense
# route's fp32 (N, E, C, ff) transients of ``expert_ffn`` (1.4 GB each at 64
# experts of width 1408, top-6, against 5.5 GB for DeepSeek-V2-Lite's 64 x
# 2048 serving prefill in one pass) and the routed route's bf16 (T k, ff)
# and (T k, d) pair rows (0.55 and 0.81 GB there).  deepseek-moe-16b's
# 64 x 512 prefill is one slice.
DISPATCH_TOKENS = 32768


def _route(p: Params, xf: torch.Tensor, cfg: ModelConfig):
    """The router on fp32 token groups xf (N, g, d): (probabilities (N, g,
    E), the top-k gates (N, g, k), renormalised unless ``moe_renormalize``
    is off, and their experts (N, g, k))."""
    logits = torch.einsum("ngd,de->nge", xf, p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, cfg.top_k)
    if cfg.moe_renormalize:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, expert_idx


def dispatch_combine(expert_idx: torch.Tensor, gate_vals: torch.Tensor, e: int,
                     cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense route's fp32 one-hots (N, g, E, C): ``dispatch`` marks each
    kept choice's slot, ``combine`` holds its gate there.  Each choice c
    takes the next free slot of its expert in the group, choices of
    choice 0 first, and is dropped past ``cap``."""
    n, g, k = expert_idx.shape
    # per-choice accumulation keeps intermediates at (N, g, E, C)
    dispatch = torch.zeros((n, g, e, cap), dtype=torch.float32, device=expert_idx.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((n, 1, e), dtype=torch.float32, device=expert_idx.device)  # used slots
    for c in range(k):
        oh = _one_hot(expert_idx[:, :, c], e)
        pos = torch.cumsum(oh, dim=1) - 1.0 + counts                # (N, g, E)
        keep = (pos < cap).float() * oh
        slot = pos.clamp(0, cap - 1).to(torch.int64)
        sel = _one_hot(slot, cap) * keep[..., None]
        dispatch = dispatch + sel
        combine = combine + sel * gate_vals[:, :, c, None, None]
        counts = counts + keep.sum(dim=1, keepdim=True)
    return dispatch, combine


def pairs(expert_idx: torch.Tensor, gate_vals: torch.Tensor, e: int, cap: int):
    """The routed route's pair list of the same choices (the plain version
    of the one ``kernels.moe_experts`` builds on the card): (int32 ``rows``
    (N g k,): each pair's token row n g + t, sorted by expert, the kept
    pairs first, each expert's in its slots' order (group by group, slot
    by slot, as ``dispatch`` lays them out); int32 ``offsets`` (E + 1,):
    expert e's pairs are rows[offsets[e]:offsets[e + 1]] and the dropped
    choices follow offsets[E]; int32 ``pos`` (N g, k): each choice's place
    in ``rows``, -1 if dropped; fp32 ``gates`` (N g, k)).  A choice's slot
    is its expert's count of choices before it in the group, choice-major
    (``dispatch_combine``'s order), and it is kept below ``cap``."""
    n, g, k = expert_idx.shape
    ex = expert_idx.transpose(1, 2).reshape(n, k * g)              # choice-major in a group
    slot = torch.cumsum(_one_hot(ex, e), dim=1).gather(-1, ex[..., None])[..., 0] - 1
    key = torch.where(slot < cap, ex, e).reshape(-1)                # dropped choices sort last
    key_sorted, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(key_sorted, torch.arange(e + 1, device=key.device))
    rows = order // (k * g) * g + order % g
    place = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(),
                                                                    device=order.device))
    pos = torch.where(key < e, place, -1).reshape(n, k, g).transpose(1, 2).reshape(n * g, k)
    return (rows.to(torch.int32), offsets.to(torch.int32), pos.to(torch.int32),
            gate_vals.reshape(n * g, k).float())


def _routed(p: Params, xg: torch.Tensor, cfg: ModelConfig, cap: int, kernel: bool):
    """The routed experts on token groups xg (N, g, d), through the grouped
    kernel (``kernel``) or the dense one-hots: (y (N, g, d) in xg's type,
    each group's share of choices per expert f (N, E), its mean router
    probabilities (N, E))."""
    n, g, d = xg.shape
    e = cfg.num_experts
    xf = xg.float()
    probs, gate_vals, expert_idx = _route(p, xf, cfg)
    if kernel:
        k = cfg.top_k
        y = moe_experts.moe_experts(xg.reshape(n * g, d), p["w_gate"], p["w_up"], p["w_down"],
                                    expert_idx.reshape(n * g, k), gate_vals.reshape(n * g, k),
                                    g, cap).reshape(n, g, d)
    else:
        dispatch, combine = dispatch_combine(expert_idx, gate_vals, e, cap)
        xe = torch.einsum("ngd,ngec->necd", xf, dispatch).to(xg.dtype)  # (N, E, C, d)
        ye = expert_ffn(p, xe)
        y = torch.einsum("necd,ngec->ngd", ye.float(), combine).to(xg.dtype)
    f = _one_hot(expert_idx, e).sum(dim=2).mean(dim=1)              # (N, E)
    return y, f, probs.mean(dim=1)


def moe(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's type, aux loss fp32 scalar)."""
    with obs.span("layer.moe"):
        b, s, d = x.shape
        e, k = cfg.num_experts, cfg.top_k
        g = min(cfg.moe_group_size, s)
        if s % g:
            raise ValueError(f"sequence length {s} is not a multiple of the routing "
                             f"group {g} (moe_group_size {cfg.moe_group_size})")
        n = b * (s // g)
        cap = _capacity(g, e, k, cfg.capacity_factor)
        xg = x.reshape(n, g, d)
        kernel = moe_experts.takes(x, p["w_gate"], p["w_up"], p["w_down"])
        if obs.enabled():
            obs.counter("layer.moe.calls").inc(route="routed" if kernel else "dense")
        step = max(1, DISPATCH_TOKENS // g)
        parts = [_routed(p, xg[i:i + step], cfg, cap, kernel) for i in range(0, n, step)]
        y, f, pmean = parts[0] if len(parts) == 1 else (torch.cat(t) for t in zip(*parts))
        y = y.reshape(b, s, d)

        if "shared" in p:
            y = y + mlp(p["shared"], x)

        # Switch load-balance loss: E * mean_e f_e * P_e
        aux = e * (f * pmean).sum(dim=-1).mean()
        return y, aux
