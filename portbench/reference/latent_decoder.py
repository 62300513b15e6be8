"""The plain reference of the latent-attention decoder (DeepSeek-V2-Lite):
latent attention with a direct query projection and YaRN RoPE, a leading
dense layer, then the MoE with top-k gates that are not renormalised.

Plain PyTorch in float32 with TF32 off, written from the model's equations
(arXiv:2405.04434, Sec. 2.1-2.2) and its published modelling code's
definitions (``DeepseekV2YarnRotaryEmbedding``, ``DeepseekV2Attention``,
``MoEGate``); it imports nothing of the program.  It reads the weight tree
the benchmark made (``latent_weights.make``), upcasting one layer at a
time.  ``fp8=True`` is the control, as in ``decoder.py``: every product's
two operands rounded to float8 e4m3.  Its helpers (norm, SwiGLU, capacity,
the unembedding, the float8 rounding) are ``decoder.py``'s.

* Attention, expanded: the query ``x wq`` (no query LoRA), the latent
  ``c = RMSNorm(x wkv_a[:, :r])`` and one shared rope key ``x wkv_a[:, r:]``;
  each head's key ``[c wkv_b_k, rope(k_rope)]`` and value ``c wkv_b_v``;
  the softmax scale ``(nope + rope) ** -0.5 x mscale(factor,
  mscale_all_dim) ** 2``.  RoPE rotates halves with YaRN's frequencies
  and cos/sin factor (the published model interleaves pairs: under random
  weights a fixed permutation of the rope columns, listed in the
  configuration file).
* The MoE: softmax scores, the top-k probabilities as gates as they are
  (``moe_renormalize`` false), the repository's capacity per routing
  group (a choice past its expert's capacity is dropped), routed and shared
  SwiGLU experts.

``served_logits`` has ``decoder.py``'s interface and semantics: a prompt
left-padded to the bucket, the served tokens fed back one a step; a padding
query has no valid key and takes the mean of the ``max_seq`` cache slots'
values, the unwritten ones zero; the prompt routes in groups of
``min(moe_group_size, bucket)`` tokens, each decode token alone.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .decoder import (_NEG, _fp32, capacity, exact_fp32, layer_order, mm, q8, rms_norm, swiglu,
                      unembed)

CHUNK = 512   # queries a block of the attention


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def inv_freq(m: Dict, dim: int, device) -> torch.Tensor:
    """YaRN's frequencies (``DeepseekV2YarnRotaryEmbedding``)."""
    base, factor, orig = m["rope_theta"], m["yarn"]["factor"], m["yarn"]["original_max_pos"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))
    low = max(math.floor(corr(m["yarn"]["beta_fast"])), 0)
    high = min(math.ceil(corr(m["yarn"]["beta_slow"])), dim - 1)
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra, inter = 1.0 / base ** exps, 1.0 / (factor * base ** exps)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def rope(x: torch.Tensor, pos: torch.Tensor, m: Dict) -> torch.Tensor:
    """x (R, T, H, D), pos (R, T): rotate halves with YaRN."""
    d, f = x.shape[-1], m["yarn"]["factor"]
    scale = _mscale(f, m["yarn"]["mscale"]) / _mscale(f, m["yarn"]["mscale_all_dim"])
    ang = pos.float()[..., None] * inv_freq(m, d, x.device)
    cos, sin = (torch.cos(ang) * scale)[..., None, :], (torch.sin(ang) * scale)[..., None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(m: Dict) -> float:
    scale = 1.0 / math.sqrt(m["qk_nope_dim"] + m["qk_rope_dim"])
    if m["yarn"]["mscale_all_dim"]:
        scale *= _mscale(m["yarn"]["factor"], m["yarn"]["mscale_all_dim"]) ** 2
    return scale


def attention(w: Dict, x: torch.Tensor, m: Dict, pos: torch.Tensor, valid: torch.Tensor,
              prompt: int, max_seq: int, fp8: bool) -> torch.Tensor:
    """x (R, T, d); ``valid`` (R, T, T); a query with no valid key takes
    the mean over ``max_seq`` slots of the first ``prompt`` slots' values."""
    r, t, _ = x.shape
    h, nope, rd, vd = m["num_heads"], m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"]
    kvr = m["kv_lora_rank"]
    q = mm(x, w["wq"], fp8).reshape(r, t, h, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, m)], dim=-1)
    kv = mm(x, w["wkv_a"], fp8)
    c = rms_norm(kv[..., :kvr], w["kv_norm"], m.get("norm_eps", 1e-6))
    k_rope = rope(kv[..., None, kvr:], pos, m)
    kvb = mm(c, w["wkv_b"], fp8).reshape(r, t, h, nope + vd)
    k = q8(torch.cat([kvb[..., :nope], k_rope.expand(r, t, h, rd)], dim=-1), fp8)
    v = kvb[..., nope:]
    q, vq = q8(q, fp8), q8(v, fp8)
    scale = softmax_scale(m)
    outs = []
    for c0 in range(0, t, CHUNK):
        c1 = min(t, c0 + CHUNK)
        s = torch.einsum("rqhd,rkhd->rhqk", q[:, c0:c1], k) * scale
        s = torch.where(valid[:, None, c0:c1], s, _NEG)
        outs.append(torch.einsum("rhqk,rkhd->rqhd", q8(torch.softmax(s, dim=-1), fp8), vq))
    o = torch.cat(outs, dim=1)
    mean = v[:, :prompt].sum(1, keepdim=True) / max_seq                # (R, 1, H, vd)
    o = torch.where(~valid.any(-1)[..., None, None], mean, o)
    return mm(o.reshape(r, t, h * vd), w["wo"], fp8)


def route(x: torch.Tensor, w: Dict, m: Dict, segments: List[Tuple[int, int, int]], fp8: bool):
    """``decoder.route`` with the top-k probabilities as gates, renormalised
    only where ``moe_renormalize`` says so."""
    e, k = m["num_experts"], m["top_k"]
    probs = torch.softmax(mm(x, w["router"], fp8), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    if m.get("moe_renormalize", True):
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    kept = torch.zeros_like(idx, dtype=torch.bool)
    r = x.shape[0]
    for start, length, g in segments:
        cap = capacity(g, e, k, m.get("capacity_factor", 1.25))
        sub = idx[:, start:start + length].reshape(r, length // g, g, k)
        used = torch.zeros(r, length // g, 1, e, device=x.device)
        keep = torch.zeros_like(sub, dtype=torch.bool)
        for c in range(k):
            one = F.one_hot(sub[..., c], e).float()
            slot = torch.cumsum(one, dim=2) - 1.0 + used
            ok = (slot < cap) & (one > 0)
            keep[..., c] = ok.any(-1)
            used = used + ok.float().sum(2, keepdim=True)
        kept[:, start:start + length] = keep.reshape(r, length, k)
    return idx, gates, kept


def moe(w: Dict, x: torch.Tensor, m: Dict, segments, fp8: bool) -> torch.Tensor:
    idx, gates, kept = route(x, w, m, segments, fp8)
    flat = x.reshape(-1, x.shape[-1])
    weight = (gates * kept).reshape(-1, idx.shape[-1])
    idx = idx.reshape(-1, idx.shape[-1])
    y = torch.zeros_like(flat)
    for e in range(m["num_experts"]):
        tok, choice = torch.nonzero((idx == e) & (weight > 0), as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = flat[tok]
        h = F.silu(mm(xe, w["w_gate"][e], fp8)) * mm(xe, w["w_up"][e], fp8)
        y.index_add_(0, tok, mm(h, w["w_down"][e], fp8) * weight[tok, choice, None])
    y = y.reshape(x.shape)
    if "shared" in w:
        y = y + swiglu(w["shared"], x, fp8)
    return y


def served_logits(params: Dict, m: Dict, prompts: torch.Tensor, offsets: torch.Tensor,
                  fed: torch.Tensor, max_seq: int, *, fp8: bool = False) -> torch.Tensor:
    """Logits (R, N + 1, V) fp32 that predict each served token of R
    requests, as ``decoder.served_logits``."""
    with torch.no_grad(), exact_fp32():
        r, plen = prompts.shape
        n = fed.shape[1]
        t = plen + n
        dev = prompts.device
        pos = torch.arange(t, device=dev)[None, :] - offsets[:, None]   # (R, T)
        valid = (pos[:, None, :] <= pos[:, :, None]) & (pos[:, None, :] >= 0)
        eps = m.get("norm_eps", 1e-6)
        x = params["embed"]["embedding"][torch.cat([prompts, fed], dim=1)].float()
        g = min(m.get("moe_group_size", 256), plen)
        segments = [(0, plen, g)] + ([(plen, n, 1)] if n else [])
        for kind, block in layer_order(params):
            w = _fp32(block)
            x = x + attention(w["attn"], rms_norm(x, w["attn_norm"], eps), m, pos, valid, plen,
                              max_seq, fp8)
            h = rms_norm(x, w["mlp_norm"], eps)
            x = x + (swiglu(w["mlp"], h, fp8) if kind == "mlp" else moe(w["moe"], h, m, segments,
                                                                       fp8))
            del w, h
        last = x[:, plen - 1:].reshape(r * (n + 1), -1)                 # the predicting slots
        out = unembed(params, m, rms_norm(last, params["final_norm"], eps), fp8)
        return out.reshape(r, n + 1, -1)
