"""Public flash attention on the model layout (B, S, H, D): the CUDA kernel
on a CUDA tensor, the plain version on a CPU tensor.

Counterpart of ``repro/kernels/flash_attention/ops.py::mha``.  There is no
fallback between the two routes: a CUDA tensor launches the kernel or
raises.  Unlike the reference, no sequence is too short for the kernel (no
``_MIN_SEQ`` route) and nothing is padded: the kernel masks ragged lengths
itself and reads (B, S, H, D) through strides, so the reference's four
transposing copies are gone on the card.  The reference's refusal of
non-causal attention over padded keys is kept under the reference's own
condition, so both packages accept the same calls.

Past ``mha``'s checks the product is the registered op
``torch.ops.repro_torch.flash_attention`` (``torch.library.custom_op``, as
K1's ``repro_torch::zorder_matmul``): the CPU implementation is the plain
version, the CUDA one launches the kernel, and a fake implementation gives
the output's shape and type without touching memory.  Being an op of the
dispatcher, it is what a dispatch mode sees as one call (the cost counter,
``repro_torch.roofline.hlo_stats``) and what a fake tensor runs through (the
dry run).  It has no autograd formula: ``mha`` refuses gradients first.

With ``repro_torch.obs`` tracing enabled, each call of the op counts in
``kernel.flash_attention.launches{route}`` and is a
``kernel.flash_attention`` span around the launch (the plain version's
call on the CPU, route ``plain``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs

from . import kernel
from .ref import attention_ref

# The reference's default block_kv and the length below which it sends
# every call to its oracle; they decide when it pads the keys.
REF_BLOCK_KV = 512
REF_MIN_SEQ = 256


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0,
        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S_q, H_q, D); k, v: (B, S_kv, H_kv, D) -> (B, S_q, H_q, D).

    Query i and key j sit at positions i and j, both counted from 0; a key
    is valid when j <= i (``causal``) and j > i - ``window`` (``window`` >
    0).  fp32 softmax statistics; a row with no valid key outputs 0."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, S_q, H_q, D), k and v (B, S_kv, H_kv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    if (sq >= REF_MIN_SEQ and skv >= REF_MIN_SEQ and not causal
            and skv % min(REF_BLOCK_KV, skv)):
        raise NotImplementedError("non-causal padding not needed by the models")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # on both devices, so the CPU's plain version does not train what the
        # card refuses
        raise NotImplementedError("flash attention has no backward kernel yet: "
                                  "call it under torch.no_grad(), or train with "
                                  "attn_impl='xla'")
    return flash_attention_op(q, k, v, causal, window, scale)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types=("cpu", "cuda"))
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       window: int, scale: Optional[float]) -> torch.Tensor:
    """``mha``'s product as an op of the dispatcher (module docstring):
    the kernel on CUDA tensors, the plain version on CPU tensors; a new
    contiguous (B, S_q, H_q, D) in q's type.  ``mha`` checks the arguments."""
    if not obs.enabled():
        return _run(q, k, v, causal, window, scale)
    route = ("plain" if q.device.type == "cpu" else
             kernel.route(q.shape[-1], q.dtype, kernel.aligned(q, k, v)))
    obs.counter("kernel.flash_attention.launches").inc(route=route)
    with obs.span("kernel.flash_attention", b=q.shape[0], sq=q.shape[1], skv=k.shape[1],
                  h=q.shape[2], d=q.shape[3], causal=causal, route=route):
        return _run(q, k, v, causal, window, scale)


def _run(q, k, v, causal, window, scale):
    if q.device.type == "cpu":
        b, sq, hq, d = q.shape

        def to_heads(x):  # (B, S, H, D) -> (B*H, S, D)
            return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])

        o = attention_ref(to_heads(q), to_heads(k), to_heads(v), causal=causal,
                          window=window, scale=scale)
        return o.reshape(b, hq, sq, d).transpose(1, 2).contiguous()
    return kernel.flash_attention_bshd(q, k, v, causal=causal, window=window, scale=scale)


@flash_attention_op.register_fake
def _(q, k, v, causal, window, scale):
    return q.new_empty(q.shape)
