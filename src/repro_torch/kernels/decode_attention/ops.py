"""Decode attention: the split-KV kernel on CUDA tensors, the plain version
on CPU tensors, and the same product as an op of the dispatcher.

``chunked_attention`` (``repro_torch.layers.attention``) sends a call to
``decode_attention`` when it has one query per row and ``takes`` accepts
the tensors; every other call stays on its plain einsum (``_sdpa``).  The
product is also the registered op ``torch.ops.repro_torch.decode_attention``
(``torch.library.custom_op``, as K2's ``repro_torch::flash_attention``):
the CUDA implementation launches the kernel on the current stream, the CPU
implementation is ``_sdpa`` with fp32 probabilities (``plain``), and a fake
implementation gives the output's shape and type.  It has no autograd
formula: ``takes`` refuses operands that require grad.

``decode_attention`` calls the op's body directly, without the dispatcher
hop, as K1's ``matmul`` does without grad: an op made by ``custom_op``
imports ``torch._dynamo`` at its first call, seconds of a server's set-up.
On fake tensors or under a dispatch mode (the cost counter,
``repro_torch.roofline.hlo_stats``, or a fake mode) it calls the op, as K1
and K2 do there: a fake mode gets the fake implementation, and the counter
sees one ``repro_torch::decode_attention`` and prices what the kernel does
(``hlo_stats.decode_cost``: the valid slots' K and V read once), not the
plain version's fp32 upcast of the whole cache.

With ``repro_torch.obs`` tracing enabled, each call counts in
``kernel.decode_attention.launches{route}`` (``split_kv`` for the kernel,
``plain`` for the CPU version) and is a ``kernel.decode_attention`` span
around the launch.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.device import dispatch_mode_active, is_fake

from . import kernel


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qpos: torch.Tensor,
                     kpos: torch.Tensor, window: int, scale: float,
                     causal: bool) -> torch.Tensor:
    """q (B, 1, Hkv, G, Dk) against k (B, S, Hkv, Dk), v (B, S, Hkv, Dv),
    with ``_sdpa``'s mask of ``qpos`` and ``kpos`` -> (B, 1, Hkv, G, Dv) in
    v's type; fp32 scores, softmax and probabilities."""
    if is_fake(q) or dispatch_mode_active():
        return decode_attention_op(q, k, v, qpos, kpos, window, scale, causal)
    return _traced(q, k, v, qpos, kpos, window, scale, causal)


def plain(q, k, v, qpos, kpos, window, scale, causal):
    """The plain version: ``_sdpa`` with fp32 probabilities."""
    from repro_torch.layers.attention import _sdpa   # that module routes calls here
    return _sdpa(q, k, v, qpos, kpos, window, scale, causal, torch.float32)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types=("cpu", "cuda"))
def decode_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qpos: torch.Tensor,
                        kpos: torch.Tensor, window: int, scale: float,
                        causal: bool) -> torch.Tensor:
    """``decode_attention``'s product as an op of the dispatcher (module
    docstring)."""
    return _traced(q, k, v, qpos, kpos, window, scale, causal)


@decode_attention_op.register_fake
def _(q, k, v, qpos, kpos, window, scale, causal):
    return v.new_empty((*q.shape[:-1], v.shape[-1]))


def _traced(q, k, v, qpos, kpos, window, scale, causal):
    if not obs.enabled():
        return _run(q, k, v, qpos, kpos, window, scale, causal)
    route = "plain" if q.device.type == "cpu" else "split_kv"
    obs.counter("kernel.decode_attention.launches").inc(route=route)
    b, _, hkv, g, dk = q.shape
    with obs.span("kernel.decode_attention", b=b, s=k.shape[1], hkv=hkv, g=g, dk=dk,
                  dv=v.shape[-1], causal=causal, route=route):
        return _run(q, k, v, qpos, kpos, window, scale, causal)


def _run(q, k, v, qpos, kpos, window, scale, causal):
    if q.device.type == "cpu":
        return plain(q, k, v, qpos, kpos, window, scale, causal)
    return kernel.decode_attention(q, k, v, qpos, kpos, window=window, scale=scale,
                                   causal=causal)
