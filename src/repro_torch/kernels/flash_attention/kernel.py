"""Launch wrappers for the hand-written Hopper flash attention (K2, ``csrc/``).

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention``.
On the TPU the kv axis was the sequential last grid axis, with the running
statistics carried in VMEM scratch; on Hopper one CTA owns a (batch, head,
query tile) and loops over only the KV tiles its causal and window limits
let in (``kv_tiles`` mirrors that walk).  Three routes, chosen by ``route``
as a pure function of (head dim, dtype, alignment); a launch the chosen
route refuses raises, it never moves to another route:

* ``wgmma`` (``csrc/flash_attention_wgmma.cu``): bf16, 64 <= D <= 128, D a
  multiple of 8, 16-byte aligned bases and (batch, seq, head) strides that
  are multiples of 8 elements (what TMA takes).  A producer warp streams
  Q, K and V by TMA through 4-D tensor maps (``tma_geometry``), two
  consumer warpgroups run ``wgmma`` on 128 x 128 tiles and take turns at
  the tensor cores so that one's softmax overlaps the other's products.
* ``mma`` (``csrc/flash_attention.cu``): every other bf16 call; takes
  D <= 128 with the same alignment (``cp.async`` double buffering,
  ``mma.sync`` on 64 x 64 tiles) and raises on the rest.
* ``fma`` (same file): fp32, plain FMA, never TF32.

See the source notes in the ``.cu`` files for each kernel's bound and what
its design does about it.  Every kernel reads the tensors through their
(batch, seq, head) strides with the last dim contiguous, so
``flash_attention`` takes the reference's (BH, S, D) layout and
``flash_attention_bshd`` the model's (B, S, H, D) one, both in place.
``launches`` counts accepted launches and ``launches_by_route`` the same per
route; ``reset_launches`` zeroes both, so a run can show which kernel its
attention went through.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import bind_thread
from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I, I64, P

MAX_HEAD_DIM = 128
WGMMA_MIN_HEAD_DIM = 64
# The wgmma route's tiles: query rows per CTA (two warpgroups of 64) and
# keys per step; flash_attention_wgmma.cu compiles exactly these.
BLOCK_M = 128
BLOCK_N = 128
TMA_BOX_D = 64          # one TMA box spans 64 head-dim elements: the 128-byte swizzle
ROUTES = ("wgmma", "mma", "fma")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GEOMETRY = ctypes.c_int64 * 33   # (dims 4, byte strides 3, box 4) for q, k, v

KERNEL = _build.Kernel(
    csrc=Path(__file__).resolve().parent / "csrc",
    name="flash_attention",
    signatures={
        "flash_attention_launch": ([P, P, P, P, I, I, I, I, I, I, I, *[I64] * 12,
                                    I, I, F32, P], I),
        "flash_attention_wgmma_launch": ([P, P, P, P, ctypes.POINTER(ctypes.c_int64),
                                          I, I, I, I, I, I, I64, I64, I64, I, I, F32, P], I),
        "flash_attention_error_string": ([I], ctypes.c_char_p),
    },
)

launches = 0
launches_by_route: Dict[str, int] = dict.fromkeys(ROUTES, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for r in ROUTES:
        launches_by_route[r] = 0


def build() -> Path:
    return _build.build(KERNEL)


def load() -> ctypes.CDLL:
    return _build.load(KERNEL)


def aligned(*tensors: torch.Tensor, tma: bool = True) -> bool:
    """Whether 16-byte copies take these (B, S, H, D) views: bases 16-byte
    aligned, and the stride of every (batch, seq, head) dim longer than 1
    a multiple of 8 elements (16 bf16 bytes).  TMA (``tma``) also needs
    those strides positive; the mma route's copies (``tma=False``) take a
    stride of 0, a broadcast (expanded) batch or head."""
    return all(t.data_ptr() % 16 == 0 and
               all(st % 8 == 0 and (st > 0 or not tma)
                   for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)
               for t in tensors)


def route(d: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The route of a call with head dim ``d``; ``aligned`` says whether
    TMA takes the tensors (see ``aligned``)."""
    if dtype == torch.float32:
        return "fma"
    if aligned and WGMMA_MIN_HEAD_DIM <= d <= MAX_HEAD_DIM and d % 8 == 0:
        return "wgmma"
    return "mma"


def select_route(d: int, dtype: torch.dtype, is_aligned: bool,
                 forced: Optional[str] = None) -> str:
    """``route`` unless ``forced`` names one; a forced route that cannot
    take the call raises (the mma route raises at launch on what it cannot
    take, as when it is chosen)."""
    if forced is None:
        return route(d, dtype, is_aligned)
    if forced not in ROUTES:
        raise ValueError(f"unknown route {forced!r}; the routes are {ROUTES}")
    want = torch.float32 if forced == "fma" else torch.bfloat16
    if dtype != want:
        raise ValueError(f"the {forced} route takes {want}, got {dtype}")
    if forced == "wgmma" and route(d, dtype, is_aligned) != "wgmma":
        raise ValueError(f"the wgmma route takes bf16 head dims {WGMMA_MIN_HEAD_DIM}-"
                         f"{MAX_HEAD_DIM} that are multiples of 8, with 16-byte aligned "
                         f"bases and strides; got head dim {d}, aligned={is_aligned}")
    return forced


def tma_geometry(shape: Sequence[int], strides: Sequence[int], box_rows: int,
                 itemsize: int = 2) -> Tuple[int, ...]:
    """The 4-D tensor map of a (B, S, H, D) view with element strides
    ``strides``: dims (D, H, S, B), the byte strides of H, S and B, and the
    box (``TMA_BOX_D``, 1, ``box_rows``, 1), as 11 ints for
    ``flash_attention_wgmma_launch``.  Dim 0 is the true D: a second box
    past it reads TMA's zero fill.  A dim of extent 1 is never stepped, so
    its stride is set to one row's bytes.  Raises on what TMA refuses:
    the last dim not contiguous, a head dim the route does not take, a
    stride that is not a positive multiple of 16 bytes below 2^40, an
    extent that int32 coordinates cannot reach, a box over 256 rows."""
    b, s, h, d = shape
    if strides[3] != 1:
        raise ValueError(f"the last (head) dim must be contiguous, stride {strides[3]}")
    if not (WGMMA_MIN_HEAD_DIM <= d <= MAX_HEAD_DIM and d % 8 == 0):
        raise ValueError(f"head dim {d}: the wgmma route takes multiples of 8 in "
                         f"{WGMMA_MIN_HEAD_DIM}-{MAX_HEAD_DIM}")
    if min(shape) <= 0 or max(shape) >= 2 ** 31:
        raise ValueError(f"extents {tuple(shape)} must be in 1 .. 2^31 - 1")
    if not 0 < box_rows <= 256:
        raise ValueError(f"a TMA box holds 1-256 rows, got {box_rows}")
    byte_strides = []
    for name, n, st in (("head", h, strides[2]), ("seq", s, strides[1]),
                        ("batch", b, strides[0])):
        nbytes = st * itemsize if n > 1 else d * itemsize
        if nbytes <= 0 or nbytes % 16 or nbytes >= 2 ** 40:
            raise ValueError(f"the {name} stride, {st} elements, is not a positive "
                             f"multiple of 16 bytes below 2^40")
        byte_strides.append(nbytes)
    return (d, h, s, b, *byte_strides, TMA_BOX_D, 1, box_rows, 1)


def kv_tiles(q0: int, sq: int, skv: int, causal: bool, window: int,
             bm: int = BLOCK_M, bn: int = BLOCK_N) -> List[Tuple[int, bool]]:
    """(first key, masked) of each key tile the kernels visit for the query
    tile of rows [q0, q0 + bm): a mirror of ``kv_range`` and
    ``tile_needs_mask`` in ``csrc/flash_common.cuh``.  The tiles run from
    the one holding the first key the window admits to the one holding the
    last key the causal limit admits; a tile is unmasked only if every
    (row < S_q, key) pair in it is valid."""
    q_last = min(q0 + bm, sq) - 1
    hi = min(skv, q_last + 1) if causal else skv
    lo = max(0, q0 - window + 1) if window > 0 else 0
    if hi <= lo:
        return []
    jb = lo // bn * bn
    return [(j0, j0 + bn > skv or (causal and j0 + bn - 1 > q0)
             or (window > 0 and j0 <= q_last - window))
            for j0 in range(jb, hi, bn)]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, *,
            causal: bool, window: int, scale: Optional[float],
            route: Optional[str] = None) -> torch.Tensor:
    """Check, pick the route (``select_route``), then launch on (B, S, H, D)
    views q, k, v and ``out`` (any strides, last dim contiguous).  Launches
    on the current stream without synchronising; raises if the launch is
    refused."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    bind_thread(q.device)
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
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the last (head) dim must be contiguous")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    r = select_route(d, q.dtype, aligned(q, k, v, out), route)
    if r != "wgmma":
        if d > MAX_HEAD_DIM:
            raise ValueError(f"head dim {d} > {MAX_HEAD_DIM} is not compiled")
        if q.dtype == torch.bfloat16 and (d % 8 or not aligned(q, k, v, tma=False)):
            raise ValueError(f"bf16 flash_attention copies 16-byte chunks: head dim {d}, "
                             f"the strides and the bases of q, k, v must be multiples of 8 "
                             f"elements (16 bytes)")
    if out.numel() == 0:
        return out
    if r == "wgmma" and skv == 0:   # no key at all: every row outputs 0
        return out.zero_()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = load()
    if r == "wgmma":
        geometry = _GEOMETRY(*tma_geometry(q.shape, q.stride(), BLOCK_M),
                             *tma_geometry(k.shape, k.stride(), BLOCK_N),
                             *tma_geometry(v.shape, v.stride(), BLOCK_N))
        rc = lib.flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geometry,
            b, hq, hkv, sq, skv, d, out.stride(0), out.stride(1), out.stride(2),
            int(causal), int(window), float(scale), stream)
    else:
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
            b, hq, hkv, sq, skv, d,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
            int(causal), int(window), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({r} route) launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()} ({rc})")
    launches += 1
    launches_by_route[r] += 1
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         scale: Optional[float] = None,
                         route: Optional[str] = None) -> torch.Tensor:
    """CUDA tensors q (B, S_q, H_q, D) and k, v (B, S_kv, H_kv, D), read in
    place -> a contiguous (B, S_q, H_q, D) in q's type.  ``route`` (for
    tests and measurements; the model never passes it) forces one of
    ``ROUTES`` or raises; None picks by ``route()``."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, causal=causal, window=window, scale=scale, route=route)


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
