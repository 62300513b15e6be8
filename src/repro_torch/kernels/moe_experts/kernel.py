"""Launch wrapper for the hand-written Hopper routed-experts kernel
(``csrc/moe_experts.cu``).

The routed experts of an MoE layer from its routing: bf16 x (T, d), the
stacked expert weights w_gate / w_up (E, d, ff) and w_down (E, ff, d) read
in place, each token's top-k experts (int64) and gates (fp32), the routing
group and the capacity.  ``pairs`` builds the pair list on the card
(``layers/moe.py``'s ``pairs``, the plain version: the kept choices'
tokens sorted by expert, the E + 1 expert offsets, each choice's place or
-1); ``moe_experts`` builds it and runs each kept pair's SwiGLU and the
combine.  It replaces no TPU kernel (the reference's MoE is a
``jnp.einsum``); see the source note for its bound and design.  ``takes``
says which calls it takes, as a pure function of the tensors;
``tile_for`` picks the tiling from the static pairs per expert.
``launches`` counts accepted launch sets (each is the pair list, the
gate-and-up product, the down product and the combine); ``reset_launches``
zeroes it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.device import aligned16, bind_thread, dispatch_mode_active, is_fake
from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P

MAX_TOP_K = 16               # choices a token may have (the combine's shared arrays)
MAX_EXPERTS = 1024           # experts the pair list's scan takes (shared-memory counts)
# Rows a tile takes (the source's BM): ``thin`` streams weights for a few
# rows an expert, ``wide`` keeps the tensor cores busy on many.
TILES = {"thin": 16, "wide": 128}
# The most pairs an expert holds on average (T k / E) for which the thin
# tiling is taken: a wide tile on fewer rows would spend most of its
# tensor-core work on padding, a thin tile on more would stream each
# weight tile once per 16 rows.
THIN_MAX_ROWS = 32

KERNEL = _build.Kernel(
    csrc=Path(__file__).resolve().parent / "csrc",
    name="moe_experts",
    signatures={
        "moe_pairs_launch": ([P] + [I] * 6 + [P] * 6, I),
        "moe_experts_launch": ([P] * 8 + [I] + [P] * 3 + [I] * 7 + [P], I),
        "moe_experts_error_string": ([I], ctypes.c_char_p),
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


def takes(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
          w_down: torch.Tensor) -> bool:
    """Whether the kernel takes this MoE call: real CUDA bf16 tensors (no
    fake tensor, no dispatch mode: a counter or a fake run prices the dense
    route), none requiring grad, stacked (E, d, ff) / (E, ff, d) weights
    with d and ff multiples of 8, at most ``MAX_EXPERTS`` experts.  The
    tensors' layout is not asked: ``moe_experts`` raises on one it cannot
    read, so a call on the card never falls back to the dense route
    unseen."""
    ts = (x, w_gate, w_up, w_down)
    if not all(t.device.type == "cuda" and t.dtype == torch.bfloat16 and not t.requires_grad
               and not is_fake(t) for t in ts) or dispatch_mode_active():
        return False
    if w_gate.ndim != 3 or w_up.shape != w_gate.shape or w_down.ndim != 3:
        return False
    e, d, ff = w_gate.shape
    return (tuple(w_down.shape) == (e, ff, d) and x.shape[-1] == d and d % 8 == 0
            and ff % 8 == 0 and e <= MAX_EXPERTS)


def tile_for(pairs: int, experts: int) -> str:
    """The tiling for ``pairs`` (T k) choices over ``experts``: thin while
    an expert holds at most ``THIN_MAX_ROWS`` of them on average."""
    return "thin" if pairs <= THIN_MAX_ROWS * experts else "wide"


def _rows_of(name: str, a: torch.Tensor, shape: Tuple[int, int], dtype: torch.dtype,
             device: torch.device) -> int:
    """``a``'s row stride, after checking it is a (rows, k) ``dtype`` matrix
    on ``device`` with its last dim contiguous."""
    if tuple(a.shape) != shape or a.dtype != dtype or a.device != device or (
            a.stride(1) != 1 and shape[1] > 1) or a.stride(0) < shape[1]:
        raise ValueError(f"want {name} {dtype} {shape} with rows of contiguous choices on "
                         f"{device}; got {a.dtype} {tuple(a.shape)} {a.stride()} on {a.device}")
    return a.stride(0)


def pairs(expert_idx: torch.Tensor, group: int, cap: int,
          num_experts: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pair list of int64 CUDA ``expert_idx`` (T, k) (rows of
    contiguous choices), in routing groups of ``group`` tokens with
    capacity ``cap`` -> new int32 (rows (T k,), offsets (E + 1,), pos (T,
    k)), as ``layers.moe.pairs`` gives them.  Launches on the current
    stream without synchronising."""
    t, k = expert_idx.shape
    if not (group >= 1 and t % group == 0 and cap >= 1 and 1 <= k <= num_experts <= MAX_EXPERTS):
        raise ValueError(f"want T a multiple of the group, cap >= 1, 1 <= k <= E <= "
                         f"{MAX_EXPERTS}; got T {t}, group {group}, cap {cap}, k {k}, "
                         f"E {num_experts}")
    dev = expert_idx.device
    ld = _rows_of("expert_idx", expert_idx, (t, k), torch.int64, dev)
    n = t // group
    i32 = dict(dtype=torch.int32, device=dev)
    rows, offsets, pos = (torch.empty(t * k, **i32), torch.empty(num_experts + 1, **i32),
                          torch.empty((t, k), **i32))
    slot, kept = torch.empty(t * k, **i32), torch.empty(n * num_experts, **i32)
    bind_thread(dev)
    lib = load()
    rc = lib.moe_pairs_launch(expert_idx.data_ptr(), ld, t, k, group, num_experts, cap,
                              rows.data_ptr(), offsets.data_ptr(), pos.data_ptr(),
                              slot.data_ptr(), kept.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_pairs launch failed: "
                           f"{lib.moe_experts_error_string(rc).decode()} ({rc})")
    return rows, offsets, pos


def moe_experts(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, expert_idx: torch.Tensor, gates: torch.Tensor,
                group: int, cap: int) -> torch.Tensor:
    """CUDA bf16 x (T, d), w_gate / w_up (E, d, ff), w_down (E, ff, d), all
    contiguous; int64 ``expert_idx`` and fp32 ``gates`` (T, k), each row's
    choices contiguous, on the same card; routing groups of ``group``
    tokens with capacity ``cap`` -> a new (T, d) bf16.  Launches on the
    current stream without synchronising; raises if the kernel does not
    take the call."""
    global launches
    if not takes(x, w_gate, w_up, w_down):
        raise ValueError("moe_experts takes CUDA bf16 x (T, d), w_gate / w_up (E, d, ff) and "
                         "w_down (E, ff, d) with no grad, d and ff multiples of 8; got "
                         f"{x.dtype} {tuple(x.shape)}, {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)} on {x.device}")
    e, d, ff = w_gate.shape
    t, k = expert_idx.shape
    ts = (x, w_gate, w_up, w_down)
    if x.ndim != 2 or x.shape[0] != t or not all(a.is_contiguous() and aligned16(a) for a in ts):
        raise ValueError(f"want contiguous 16-byte aligned x (T, d) and weights; got x "
                         f"{tuple(x.shape)} {x.stride()}, T = {t} from expert_idx")
    if k > MAX_TOP_K:
        raise ValueError(f"want at most {MAX_TOP_K} choices a token; got {k}")
    gates_ld = _rows_of("gates", gates, (t, k), torch.float32, x.device)
    rows, offsets, pos = pairs(expert_idx, group, cap, e)
    h = torch.empty((t * k, ff), dtype=x.dtype, device=x.device)
    ye = torch.empty((t * k, d), dtype=x.dtype, device=x.device)
    y = torch.empty((t, d), dtype=x.dtype, device=x.device)
    max_rows = t // group * min(group, cap)      # an expert takes a token once a group
    lib = load()
    rc = lib.moe_experts_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), rows.data_ptr(),
        offsets.data_ptr(), pos.data_ptr(), gates.data_ptr(), gates_ld, h.data_ptr(),
        ye.data_ptr(), y.data_ptr(), t, k, e, d, ff, max_rows,
        list(TILES).index(tile_for(t * k, e)), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_experts launch failed: "
                           f"{lib.moe_experts_error_string(rc).decode()} ({rc})")
    launches += 1
    return y
