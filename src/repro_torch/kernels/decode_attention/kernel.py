"""Launch wrapper for the hand-written Hopper split-KV decode attention
(``csrc/decode_attention.cu``).

One query per row against a bf16 KV cache read in place: q (B, 1, Hkv, G,
Dk), k (B, S, Hkv, Dk), v (B, S, Hkv, Dv), the key and query positions as
device tensors, the mask applied on the device.  It replaces no TPU kernel
(the reference's decode attention is an XLA einsum); see the source note
for its bound and design.  ``takes`` says which calls it takes, as a pure
function of the tensors' device, type, grad and head dims; the launcher
raises on a view its 16-byte loads cannot read (``aligned``).
``split_plan`` sizes its slot chunks from the shape and the SM count.
``launches`` counts accepted launches (each is the split kernel and its
combine); ``reset_launches`` zeroes it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.device import aligned16, bind_thread
from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I, I64, P
from repro_torch.kernels.matmul.kernel import sm_count

MAX_HEAD_DIM = 256
MAX_CHUNK = 256          # slots a CTA takes at most (its shared-memory score rows)
MIN_CHUNK = 64
BLOCKS_PER_SM = 8        # (row, head, chunk) blocks split_plan aims for per SM
MAX_GROUP = 8            # query heads of one KV head a CTA takes at once
MAX_SLOT_HEADS = 512     # slots x query heads of a CTA's chunk: its share of the work

KERNEL = _build.Kernel(
    csrc=Path(__file__).resolve().parent / "csrc",
    name="decode_attention",
    signatures={
        "decode_attention_launch": ([P] * 8 + [I] * 6 + [I64] * 15 + [I, I, F32, I, I, P], I),
        "decode_attention_error_string": ([I], ctypes.c_char_p),
    },
)

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def build() -> Path:
    return _build.build(KERNEL)


def load() -> ctypes.CDLL:
    return _build.load(KERNEL)


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether 16-byte loads take these views: bases 16-byte aligned and
    the stride of every dim but the last that is longer than 1 a multiple
    of 8 elements."""
    return all(aligned16(t) and t.stride(-1) == 1 and
               all(st % 8 == 0 for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)
               for t in tensors)


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel takes this one-query call (q (B, 1, Hkv, G, Dk),
    k (B, S, Hkv, Dk), v (B, S, Hkv, Dv)): CUDA bf16 tensors, none
    requiring grad, head dims multiples of 8 up to ``MAX_HEAD_DIM``.  The
    views' alignment is not asked: ``decode_attention`` raises on a view
    that ``aligned`` refuses, so a call on the card never falls back to
    the plain version unseen."""
    dk, dv = q.shape[-1], v.shape[-1]
    return (all(t.device.type == "cuda" and t.dtype == torch.bfloat16 and not t.requires_grad
                for t in (q, k, v))
            and dk % 8 == 0 and dv % 8 == 0 and max(dk, dv) <= MAX_HEAD_DIM)


def group_tile(g: int) -> int:
    """Query heads a CTA takes at once: G rounded up to 1, 2, 4 or 8 (the
    kernel's GT)."""
    return 1 if g == 1 else 2 if g == 2 else 4 if g <= 4 else MAX_GROUP


def split_plan(b: int, hkv: int, g: int, s: int, sms: int) -> Tuple[int, int]:
    """(chunk, splits): slots per CTA and CTAs per (row, KV head, query
    head group).  Enough splits that the blocks number ``BLOCKS_PER_SM``
    per SM, and chunks short enough that a CTA's slots times its query
    heads stay within ``MAX_SLOT_HEADS`` (danube's 4 heads of a KV head
    take 128 slots, deepseek's 1 takes 256); each chunk a multiple of 32
    slots from ``MIN_CHUNK`` to ``MAX_CHUNK``, never longer than S."""
    groups = b * hkv * -(-g // MAX_GROUP)
    per = -(-s // -(-BLOCKS_PER_SM * sms // groups))     # slots a block for that count
    per = min(per, MAX_SLOT_HEADS // group_tile(g))
    chunk = min(MAX_CHUNK, max(MIN_CHUNK, -(-per // 32) * 32), s)
    return chunk, -(-s // chunk)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qpos: torch.Tensor,
                     kpos: torch.Tensor, *, window: int, scale: float,
                     causal: bool) -> torch.Tensor:
    """CUDA bf16 q (B, 1, Hkv, G, Dk), k (B, S, Hkv, Dk), v (B, S, Hkv, Dv),
    read in place; int64 ``qpos`` (1,) or (B, 1) and ``kpos`` (S,) or (B, S)
    on the same card -> a new contiguous (B, 1, Hkv, G, Dv) bf16, in chunks
    of ``split_plan``'s size.  Launches on the current stream without
    synchronising; raises if the kernel does not take the call or a view
    is not ``aligned``."""
    global launches
    if not (takes(q, k, v) and aligned(q, k, v)):
        raise ValueError("decode_attention takes CUDA bf16 q, k, v with no grad, head dims "
                         f"multiples of 8 up to {MAX_HEAD_DIM}, 16-byte aligned views; got "
                         f"{q.dtype} {tuple(q.shape)} {q.stride()}, {tuple(k.shape)} "
                         f"{k.stride()}, {tuple(v.shape)} {v.stride()} on {q.device}")
    b, sq, hkv, g, dk = q.shape
    bk, s, hk, dkk = k.shape
    dv = v.shape[-1]
    if sq != 1 or (bk, hk, dkk) != (b, hkv, dk) or v.shape[:3] != k.shape[:3] or s == 0:
        raise ValueError(f"want q (B, 1, Hkv, G, Dk), k (B, S, Hkv, Dk), v (B, S, Hkv, Dv); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    qpos, kpos = qpos.to(torch.int64), kpos.to(torch.int64)
    if qpos.numel() not in (1, b) or qpos.shape[-1] != 1 or kpos.shape[-1] != s \
            or kpos.ndim > 2 or (kpos.ndim == 2 and kpos.shape[0] not in (1, b)):
        raise ValueError(f"want qpos (1,) or (B, 1) and kpos (S,) or (B, S); got "
                         f"{tuple(qpos.shape)}, {tuple(kpos.shape)}")
    if not (qpos.device == kpos.device == q.device == k.device == v.device):
        raise ValueError("q, k, v and the positions must be on one device")
    bind_thread(q.device)
    qp_sb = qpos.reshape(-1).stride(0) if qpos.numel() > 1 else 0
    kp_sb = kpos.stride(0) if kpos.ndim == 2 and kpos.shape[0] > 1 else 0
    kp_ss = kpos.stride(-1)
    chunk, nsplit = split_plan(b, hkv, g, s, sm_count(q.device))
    out = torch.empty((b, 1, hkv, g, dv), dtype=v.dtype, device=q.device)
    rows = b * hkv * g
    part_ml = torch.empty((rows * nsplit * 2,), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((rows * nsplit * dv,), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = load()
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, s, hkv, g, dk, dv,
        q.stride(0), q.stride(2), q.stride(3), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(2), out.stride(3),
        qp_sb, kp_sb, kp_ss, int(causal), int(window), float(scale), chunk, nsplit, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: "
                           f"{lib.decode_attention_error_string(rc).decode()} ({rc})")
    launches += 1
    return out
