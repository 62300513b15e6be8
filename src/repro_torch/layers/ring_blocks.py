"""Ring-TP MLP block: the paper-derived collective matmuls at layer level.

Counterpart of ``repro.layers.ring_blocks``.  The block prescribes its
collective schedule: the Megatron sequence-parallel layout, with the
all-gather and the reduce-scatter decomposed into one-hop ``ppermute``
chains overlapped with per-chunk products (``dist.ring``), the 1-D
solutions of the paper's torus equations.  Each chunk's product is
``local_matmul``, so the Z-order matmul kernel (K1) on the card.

Layout contract (a per-rank program, e.g. under ``Mesh.run``, with
``tp_axis`` the ring axis of size t):
  x            : (B, S/t, d)  sequence-sharded activations
  out          : (B, S/t, d)  the same
  w_gate, w_up : (d, f/t)     column-parallel shards
  w_down       : (f/t, d)     row-parallel shard
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.dist.ring import ring_ag_matmul, ring_rs_matmul

Params = Dict[str, torch.Tensor]


def ring_mlp(p_local: Params, x: torch.Tensor, tp_axis: str = "model") -> torch.Tensor:
    """One rank's part of the SwiGLU MLP: x (B, S_loc, d) sequence-sharded
    over ``tp_axis``; ``p_local`` its shards of w_gate / w_up (d, f_loc)
    and w_down (f_loc, d)."""
    # ring all-gather products: (B, S_loc, d) -> (B, S, f_loc), overlapped
    g = ring_ag_matmul(x, p_local["w_gate"], tp_axis)
    u = ring_ag_matmul(x, p_local["w_up"], tp_axis)
    h = F.silu(g) * u
    # ring reduce-scatter product: (B, S, f_loc) -> (B, S_loc, d), reduced
    return ring_rs_matmul(h, p_local["w_down"], tp_axis)


def gspmd_mlp_reference(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The plain data flow of the unsharded block (global view): each
    product accumulated in fp32 and rounded to x's type, as the
    reference's ``preferred_element_type=float32`` products."""
    def mm(a, w):
        return torch.matmul(a.float(), w.float())

    g = F.silu(mm(x, p["w_gate"])).to(x.dtype)
    u = mm(x, p["w_up"]).to(x.dtype)
    return mm((g.float() * u.float()).to(x.dtype), p["w_down"]).to(x.dtype)
