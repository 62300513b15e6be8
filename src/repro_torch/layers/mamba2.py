"""Mamba-2 (SSD) layer: chunked scan for the uncached pass, O(1) decode step.

Counterpart of ``repro.layers.mamba2``.  Shapes: d_in = expand * d_model;
H = d_in / headdim heads of P = headdim; state N; B_t and C_t shared across
heads (one group).  ``in_proj`` and ``out_proj`` go through ``linear`` and
so through the Z-order matmul kernel (K1); the causal conv, the gates and
the SSD scan are ``torch.einsum`` and elementwise ops, as the reference
computes them with ``jnp.einsum`` outside any Pallas kernel.  The
reference's ``lax.scan`` over chunks is a Python loop over chunks here.

The decode cache ``{"conv", "ssm"}`` is preallocated and written in place
(``copy_``), so one captured CUDA graph serves every step; the reference
returns a new cache.  A cached call takes one token.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .linear import linear, linear_params
from .norms import rms_norm, rms_norm_params

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]


def dims(cfg) -> Tuple[int, int, int, int]:
    """(d_in, N, H, P) of a config's Mamba-2 layer."""
    din = cfg.ssm_expand * cfg.d_model
    return din, cfg.ssm_state, din // cfg.ssm_headdim, cfg.ssm_headdim


def mamba2_params(generator: torch.Generator, cfg, dtype: torch.dtype, device) -> Params:
    d = cfg.d_model
    din, n, h, _ = dims(cfg)
    kconv = cfg.conv_kernel
    conv_ch = din + 2 * n
    conv_w = torch.randn((kconv, conv_ch), generator=generator, dtype=torch.float32,
                         device=generator.device) * (1.0 / kconv)
    return {
        # in_proj -> [z, x, B, C, dt]
        "in_proj": linear_params(generator, d, 2 * din + 2 * n + h, dtype, device),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=device)),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm": rms_norm_params(din, device),
        "out_proj": linear_params(generator, din, d, dtype, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``F.softplus``
    switches to the identity above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, the taps summed in fp32 and cast once.
    x: (B, S, C); w: (K, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s, :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) at the end by ``pad``."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))


def causal_gate(mask: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """``exp(decay)`` where ``mask`` holds, else 0, as
    ``exp(where(mask, decay, -inf))``.  The reference computes
    ``where(mask, exp(decay), 0)`` (Mamba-2's SSD and mLSTM's chunk scans).
    Above the diagonal a decay is a positive sum of log decays, its ``exp``
    can overflow to inf, and the backward then multiplies the masked
    entries' zero cotangent by that inf: NaN in every gradient upstream of
    the scan (zamba2's smoke model in the reference).  Masking before the
    ``exp`` gives the same forward bit for bit (kept entries are the same
    ``exp``, masked ones 0 either way) and finite gradients, equal to the
    reference's wherever those are finite."""
    return torch.exp(torch.where(mask, decay, -torch.inf))


def _ssd_chunk_scan(xh, dt, Bm, Cm, A, chunk: int, gate_dtype=None):
    """Chunked SSD.  xh: (B, S, H, P); dt: (B, S, H) fp32; Bm, Cm: (B, S, N);
    A: (H,) negative.  Returns y (B, S, H, P) fp32 and the final state
    (B, H, P, N).  ``gate_dtype=torch.bfloat16`` rounds the (L, L, H)
    weights before their product with x, as the reference's knob.  The
    intra-chunk decays pass through ``causal_gate``, which departs from the
    reference's expression (its docstring says why)."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    pad = (-s) % chunk
    if pad:  # a trailing zero-pad is causal-safe; outputs sliced back below
        xh, dt, Bm, Cm = (_pad_seq(t, pad) for t in (xh, dt, Bm, Cm))
    nc, L = (s + pad) // chunk, chunk
    la = dt.float() * A                                      # (B, S, H) log decay per step
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        xk, dtk, Bk, Ck, lak = xh[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl], la[:, sl]
        Bf, Cf = Bk.float(), Ck.float()
        # cumulative log decay within the chunk (inclusive)
        cum = torch.cumsum(lak, dim=1)                                   # (B, L, H)
        # intra-chunk: y_i = sum_{j<=i} C_i.B_j exp(cum_i - cum_j) dt_j x_j
        scores = torch.einsum("bin,bjn->bij", Cf, Bf)                    # (B, L, L)
        decay = cum[:, :, None, :] - cum[:, None, :, :]                  # (B, L, L, H)
        gate = causal_gate(mask[None, :, :, None], decay)
        w = scores[..., None] * gate * dtk[:, None, :, :]                # (B, L, L, H)
        if gate_dtype is not None:
            w = w.to(gate_dtype)
        # fp32 accumulation of the (possibly rounded) operands' products
        y = torch.einsum("bijh,bjhp->bihp", w.float(), xk.to(w.dtype).float())
        # inter-chunk: y_i += exp(cum_i) * C_i . h_prev
        y = y + torch.einsum("bin,bhpn,bih->bihp", Cf, hstate, torch.exp(cum))
        # state: h = exp(cum_L) h_prev + sum_j exp(cum_L - cum_j) dt_j B_j x_j
        tot = cum[:, -1:, :]                                             # (B, 1, H)
        carry_decay = torch.exp(tot - cum)                               # (B, L, H)
        hnew = torch.einsum("bjh,bjn,bjhp->bhpn", carry_decay * dtk, Bf, xk.float())
        hstate = hstate * torch.exp(tot[:, 0, :])[:, :, None, None] + hnew
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], hstate


def mamba2(p: Params, x: torch.Tensor, cfg, cache: Optional[Cache] = None,
           pos=None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, d_model).  With ``cache`` (decode, S = 1): shift the conv
    state, take one recurrent step, write both states in place.  ``pos`` is
    unused (the state has no slots), as in the reference."""
    b, s, _ = x.shape
    din, n, h, ph = dims(cfg)

    proj = linear(x, p["in_proj"])
    z, xr, Bm, Cm, dt = torch.split(proj, [din, din, n, n, h], dim=-1)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)

    if cache is None:
        conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    else:
        if s != 1:
            raise ValueError(f"a cached Mamba-2 step takes one token, got {s}")
        # the shifted window is a new tensor, so the in-place write below
        # does not read what it overwrites
        cs = torch.cat([cache["conv"][:, 1:], conv_in], dim=1)          # (B, K, C)
        conv = (torch.einsum("bkc,kc->bc", cs.float(), p["conv_w"].float())
                + p["conv_b"].float())[:, None, :].to(x.dtype)
        cache["conv"].copy_(cs)

    conv = F.silu(conv.float()).to(x.dtype)
    xr, Bm, Cm = torch.split(conv, [din, n, n], dim=-1)
    xh = xr.reshape(b, s, h, ph)
    dt = softplus(dt.float() + p["dt_bias"])                            # (B, S, H)
    A = -torch.exp(p["A_log"])                                          # (H,)

    if cache is None:
        chunk = min(cfg.ssm_chunk, s)
        gdt = torch.bfloat16 if getattr(cfg, "gate_dtype", "fp32") == "bf16" else None
        y, _ = _ssd_chunk_scan(xh, dt, Bm, Cm, A, chunk, gate_dtype=gdt)
    else:
        # O(1) recurrent step on the state (B, H, P, N)
        a = torch.exp(dt[:, 0, :] * A)                                  # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0, :], Bm[:, 0].float(),
                           xh[:, 0].float())
        hstate = cache["ssm"] * a[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), hstate)[:, None]
        cache["ssm"].copy_(hstate)

    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(b, s, din).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)                               # gated
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return linear(y, p["out_proj"]), cache


def mamba2_cache(cfg, batch: int, dtype: torch.dtype, device) -> Cache:
    din, n, h, ph = dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel, din + 2 * n), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, ph, n), dtype=torch.float32, device=device),
    }
