"""Launch wrapper for the hand-written Hopper flash attention (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention``.
On the TPU the kv axis was the sequential last grid axis, with the running
statistics carried in VMEM scratch; on Hopper one CTA owns a (batch, head,
query tile) and loops over only the KV tiles its causal and window limits
let in, with K and V double-buffered through shared memory by ``cp.async``.
See the source note in the ``.cu`` file for the kernel's bound and what its
design does about it.

The kernel reads every tensor through (batch, seq, head) strides with the
last dim contiguous, so ``flash_attention`` takes the reference's
(BH, S, D) layout and ``flash_attention_bshd`` the model's (B, S, H, D)
one, both in place.  ``launches`` counts accepted launches; a run that
resets it to 0 can show that its attention went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I, I64, P

MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = _build.Kernel(
    csrc=Path(__file__).resolve().parent / "csrc",
    name="flash_attention",
    signatures={
        "flash_attention_launch": ([P, P, P, P, I, I, I, I, I, I, I, *[I64] * 12,
                                    I, I, F32, P], I),
        "flash_attention_error_string": ([I], ctypes.c_char_p),
    },
)

launches = 0


def build() -> Path:
    return _build.build(KERNEL)


def load() -> ctypes.CDLL:
    return _build.load(KERNEL)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, *,
            causal: bool, window: int, scale: Optional[float]) -> torch.Tensor:
    """Check, then launch on (B, S, H, D) views q, k, v and ``out`` (any
    strides, last dim contiguous).  Launches on the current stream without
    synchronising; raises if the launch is refused."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, S_q, H_q, D), k and v (B, S_kv, H_kv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    bk, skv, hkv, dk = k.shape
    if bk != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v {tuple(k.shape)}: "
                         f"batch and head dim must match and H_q % H_kv == 0")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM} is not compiled")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the last (head) dim must be contiguous")
    if q.dtype == torch.bfloat16 and (
            d % 8 or any(t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
                         for t in (q, k, v))):
        raise ValueError(f"bf16 flash_attention copies 16-byte chunks: head dim {d}, the "
                         f"strides and the bases of q, k, v must be multiples of 8 "
                         f"elements (16 bytes)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lib = load()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
        b, hq, hkv, sq, skv, d,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
        int(causal), int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()} ({rc})")
    launches += 1
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """CUDA tensors q (B, S_q, H_q, D) and k, v (B, S_kv, H_kv, D), read in
    place -> a contiguous (B, S_q, H_q, D) in q's type."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, causal=causal, window=window, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The reference's signature: q (BH_q, S_q, D); k, v (BH_kv, S_kv, D)
    with BH_q % BH_kv == 0 (query head h reads KV head h // group).
    Returns a contiguous (BH_q, S_q, D).  Each tensor is viewed as one
    batch of BH heads, (1, S, BH, D), so nothing is copied."""
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError(f"want q (BH_q, S_q, D), k and v (BH_kv, S_kv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")

    def bshd(x):
        return x.unsqueeze(0).transpose(1, 2)

    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(bshd(q), bshd(k), bshd(v), bshd(out), causal=causal, window=window,
            scale=scale)
    return out
