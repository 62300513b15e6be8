"""xLSTM layers: chunkwise-parallel mLSTM and sequential sLSTM.

Counterpart of ``repro.layers.xlstm``, with its bounded sigmoid gates (f, i
in (0, 1), no stabilizer state).  The q/k/v/o projections go through
``linear`` and so through the Z-order matmul kernel (K1); the gate
projections (``w_gates``, ``w_in``, fp32), the chunk scan, the sLSTM
recurrence and the state updates are ``torch.einsum`` and elementwise ops,
as the reference computes them outside any Pallas kernel.  The
reference's ``lax.scan`` over chunks (mLSTM) and over time (sLSTM) is a
Python loop here.

The decode caches (mLSTM ``{"C", "n"}``, sLSTM ``{"h", "c", "n"}``) are
preallocated and written in place (``copy_``), so one captured CUDA graph
serves every step; the reference returns new ones.  A cached call takes
one token.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .linear import linear, linear_params
from .mamba2 import _pad_seq, causal_gate
from .norms import rms_norm, rms_norm_params

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]


def _one_token(s: int) -> None:
    if s != 1:
        raise ValueError(f"a cached xLSTM step takes one token, got {s}")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_params(generator: torch.Generator, cfg, dtype: torch.dtype, device) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    f32 = torch.float32
    return {
        "wq": linear_params(generator, d, d, dtype, device),
        "wk": linear_params(generator, d, d, dtype, device),
        "wv": linear_params(generator, d, d, dtype, device),
        "w_gates": linear_params(generator, d, 2 * h, f32, device),  # i, f per head
        # forget bias ~ sigmoid(3) = .95
        "gate_bias": torch.cat([torch.zeros((h,), dtype=f32, device=device),
                                3.0 * torch.ones((h,), dtype=f32, device=device)]),
        "norm": rms_norm_params(d, device),
        "wo": linear_params(generator, d, d, dtype, device),
    }


def _mlstm_chunk_scan(q, k, v, li, lf, chunk: int, gate_dtype=None):
    """q, k, v: (B, S, H, D); li, lf: (B, S, H) log input / forget gates.
    Returns y (B, S, H, D) fp32 and the final (C, n) state.
    ``gate_dtype=torch.bfloat16`` rounds the (L, L, H) weights before their
    product with v, as the reference's knob.  The intra-chunk decays pass
    through ``mamba2.causal_gate``, masked before the ``exp`` where the
    reference masks after it (its docstring says why)."""
    b, s, h, dh = q.shape
    pad = (-s) % chunk
    if pad:  # causal-safe trailing pad; sliced back at return
        q, k, v, li, lf = (_pad_seq(t, pad) for t in (q, k, v, li, lf))
    nc, L = (s + pad) // chunk, chunk
    scale = dh ** -0.5
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
    nrm = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        qk, kk, vk, lik, lfk = q[:, sl].float(), k[:, sl].float(), v[:, sl], li[:, sl], lf[:, sl]
        cum = torch.cumsum(lfk, dim=1)                                   # (B, L, H)
        # intra-chunk attention-like term
        sc = torch.einsum("bihd,bjhd->bijh", qk, kk) * scale
        decay = cum[:, :, None, :] - cum[:, None, :, :] + lik[:, None, :, :]
        gate = causal_gate(mask[None, :, :, None], decay)
        w = sc * gate                                                    # (B, L, L, H)
        if gate_dtype is not None:
            w = w.to(gate_dtype)
        y = torch.einsum("bijh,bjhd->bihd", w.float(), vk.to(w.dtype).float())
        # inter-chunk: y_i += exp(cum_i) q_i . C ; the denominator through n
        ecum = torch.exp(cum)
        y = y + torch.einsum("bihd,bhde,bih->bihe", qk, C, ecum) * scale
        qn = torch.einsum("bihd,bhd,bih->bih", qk, nrm, ecum) * scale
        qn = qn + torch.einsum("bijh,bjhd,bihd->bih", gate, kk, qk) * scale
        y = y / torch.clamp(torch.abs(qn), min=1.0)[..., None]
        # state update
        tot = cum[:, -1:, :]
        cd = torch.exp(tot - cum + lik)                                  # (B, L, H)
        etot = torch.exp(tot[:, 0])
        C = C * etot[:, :, None, None] + torch.einsum("bjh,bjhd,bjhe->bhde", cd, kk,
                                                      vk.float())
        nrm = nrm * etot[:, :, None] + torch.einsum("bjh,bjhd->bhd", cd, kk)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], (C, nrm)


def mlstm(p: Params, x: torch.Tensor, cfg, cache: Optional[Cache] = None,
          pos=None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, d).  With ``cache`` (decode, S = 1): one step of the matrix
    memory, written in place.  ``pos`` is unused."""
    b, s, d = x.shape
    h = cfg.num_heads
    dh = d // h
    q = linear(x, p["wq"]).reshape(b, s, h, dh)
    k = linear(x, p["wk"]).reshape(b, s, h, dh)
    v = linear(x, p["wv"]).reshape(b, s, h, dh)
    gates = torch.einsum("bsd,dg->bsg", x.float(), p["w_gates"]) + p["gate_bias"]
    li = F.logsigmoid(gates[..., :h])                                   # (B, S, H)
    lf = F.logsigmoid(gates[..., h:])

    if cache is None:
        chunk = min(getattr(cfg, "ssm_chunk", 256), s)
        gdt = torch.bfloat16 if getattr(cfg, "gate_dtype", "fp32") == "bf16" else None
        y, _ = _mlstm_chunk_scan(q, k, v, li, lf, chunk, gate_dtype=gdt)
    else:
        _one_token(s)
        f = torch.exp(lf[:, 0])                                         # (B, H)
        i = torch.exp(li[:, 0])
        k0, v0, q0 = k[:, 0].float(), v[:, 0].float(), q[:, 0].float()
        C = cache["C"] * f[:, :, None, None] + torch.einsum("bhd,bhe,bh->bhde", k0, v0, i)
        nrm = cache["n"] * f[:, :, None] + k0 * i[:, :, None]
        scale = dh ** -0.5
        y = torch.einsum("bhd,bhde->bhe", q0, C) * scale
        qn = torch.einsum("bhd,bhd->bh", q0, nrm) * scale
        y = (y / torch.clamp(torch.abs(qn), min=1.0)[..., None])[:, None]
        cache["C"].copy_(C)
        cache["n"].copy_(nrm)

    y = y.reshape(b, s, d).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return linear(y, p["wo"]), cache


def mlstm_cache(cfg, batch: int, device) -> Cache:
    h = cfg.num_heads
    dh = cfg.d_model // h
    return {"C": torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_params(generator: torch.Generator, cfg, dtype: torch.dtype, device) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    f32 = torch.float32
    r = torch.randn((4, h, dh, dh), generator=generator, dtype=f32,
                    device=generator.device) * dh ** -0.5
    return {
        "w_in": linear_params(generator, d, 4 * d, f32, device),      # z, i, f, o
        "r": r.to(device),
        "bias": torch.cat([torch.zeros((2 * d,), dtype=f32, device=device),
                           3.0 * torch.ones((d,), dtype=f32, device=device),
                           torch.zeros((d,), dtype=f32, device=device)]),
        "norm": rms_norm_params(d, device),
        "wo": linear_params(generator, d, d, dtype, device),
    }


def _slstm_step(p: Params, cfg, carry, wx_t):
    """carry: (h, c, n) each (B, H, Dh) fp32; wx_t: (B, 4d), W x_t."""
    hprev, cprev, nprev = carry
    b = hprev.shape[0]
    hc = cfg.num_heads
    dh = cfg.d_model // hc
    rec = torch.einsum("bhd,ghde->bghe", hprev, p["r"])                 # (B, 4, H, Dh)
    pre = wx_t.reshape(b, 4, hc, dh) + rec + p["bias"].reshape(4, hc, dh)
    z = torch.tanh(pre[:, 0])
    i = torch.sigmoid(pre[:, 1])
    f = torch.sigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    c = f * cprev + i * z
    n = f * nprev + i
    hnew = o * c / torch.clamp(torch.abs(n), min=1.0)
    return hnew, c, n


def slstm(p: Params, x: torch.Tensor, cfg, cache: Optional[Cache] = None,
          pos=None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, d).  Uncached: S sequential steps from a zero state.  With
    ``cache`` (decode, S = 1): one step, the state written in place.
    ``pos`` is unused."""
    b, s, d = x.shape
    h = cfg.num_heads
    dh = d // h
    wx = torch.einsum("bsd,de->bse", x.float(), p["w_in"])

    if cache is None:
        carry = tuple(torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
                      for _ in range(3))
        ys = []
        for t in range(s):
            carry = _slstm_step(p, cfg, carry, wx[:, t])
            ys.append(carry[0])
        y = torch.stack(ys, dim=1).reshape(b, s, d)
    else:
        _one_token(s)
        hn, c, n = _slstm_step(p, cfg, (cache["h"], cache["c"], cache["n"]), wx[:, 0])
        y = hn.reshape(b, 1, d)
        for key, new in (("h", hn), ("c", c), ("n", n)):
            cache[key].copy_(new)

    y = rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    return linear(y, p["wo"]), cache


def slstm_cache(cfg, batch: int, device) -> Cache:
    """Three separate zero tensors (each written in place)."""
    h = cfg.num_heads
    dh = cfg.d_model // h
    return {key: torch.zeros((batch, h, dh), dtype=torch.float32, device=device)
            for key in ("h", "c", "n")}
