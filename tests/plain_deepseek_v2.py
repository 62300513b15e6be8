"""A plain forward pass of DeepSeek-V2-Lite, for the tests to hold the port to.

Written from the model's equations (arXiv:2405.04434, Sec. 2.1 and 2.2)
and its published modelling code's definitions (``DeepseekV2Attention``,
``DeepseekV2YarnRotaryEmbedding``, ``MoEGate``), in float32 with TF32 off,
on a weight tree laid out as the port's ``DecoderLM`` lays it out.  It
imports no JAX, nothing of ``repro`` and nothing of ``repro_torch``.

* Latent attention, expanded: the query from one direct projection ``wq``
  (``q_lora_rank`` null), the key-value latent ``c = RMSNorm(x wkv_a[:, :r])``
  and one shared rope key ``x wkv_a[:, r:]``; per-head keys ``[c wkv_b_k,
  rope(k_rope)]`` and values ``c wkv_b_v``; the softmax scale
  ``(nope + rope) ** -0.5 * mscale(factor, mscale_all_dim) ** 2``.
* YaRN frequencies and the cos/sin factor as ``DeepseekV2YarnRotaryEmbedding``
  computes them, applied to the rope halves in the port's rotate-half
  layout (the published model interleaves pairs: a fixed permutation of
  the rope columns under random weights).
* A dense SwiGLU first layer, then the MoE: softmax scores, the top-k
  probabilities as gates, not renormalised (``moe_renormalize`` off), with
  the repository's capacity (a choice past its expert's next free slot in
  a group is dropped), routed and shared SwiGLU experts.

A padding query of a served batch (no valid key) takes the mean of the
values of the ``max_slots`` cache slots, the unwritten ones zero, as the
program's uniform softmax over the cache gives it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30


@contextlib.contextmanager
def exact_fp32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(m: Dict, dim: int) -> Tuple[int, int]:
    def corr(rot):
        return dim * math.log(m["yarn"]["original_max_pos"] / (rot * 2 * math.pi)) / (
            2 * math.log(m["rope_theta"]))
    low = math.floor(corr(m["yarn"]["beta_fast"]))
    high = math.ceil(corr(m["yarn"]["beta_slow"]))
    return max(low, 0), min(high, dim - 1)


def inv_freq(m: Dict, dim: int) -> torch.Tensor:
    base, factor = m["rope_theta"], m["yarn"]["factor"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (factor * base ** exps)
    low, high = yarn_correction_range(m, dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def rope(x, pos, m: Dict):
    """x (R, T, H, D), pos (R, T): rotate halves with YaRN's frequencies."""
    d = x.shape[-1]
    f = m["yarn"]["factor"]
    factor = yarn_get_mscale(f, m["yarn"]["mscale"]) / yarn_get_mscale(f, m["yarn"]["mscale_all_dim"])
    ang = pos.float()[..., None] * inv_freq(m, d).to(x.device)
    cos, sin = (torch.cos(ang) * factor)[..., None, :], (torch.sin(ang) * factor)[..., None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(m: Dict) -> float:
    scale = (m["qk_nope_dim"] + m["qk_rope_dim"]) ** -0.5
    if m["yarn"]["mscale_all_dim"]:
        scale *= yarn_get_mscale(m["yarn"]["factor"], m["yarn"]["mscale_all_dim"]) ** 2
    return scale


def attention(w: Dict, x, m: Dict, pos, valid, prompt: int, max_slots: int):
    """x (R, T, d); ``valid`` (R, T, T) the keys each query sees; a query
    with none takes the mean over ``max_slots`` slots of the values of the
    first ``prompt`` ones."""
    r, t, _ = x.shape
    h, nope, rd, vd = m["num_heads"], m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"]
    kvr, eps = m["kv_lora_rank"], m["norm_eps"]
    q = (x @ w["wq"]).reshape(r, t, h, nope + rd)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, m)], dim=-1)
    kv = x @ w["wkv_a"]
    c = rms_norm(kv[..., :kvr], w["kv_norm"], eps)
    k_rope = rope(kv[..., None, kvr:], pos, m)                       # (R, T, 1, rope)
    kvb = (c @ w["wkv_b"]).reshape(r, t, h, nope + vd)
    k = torch.cat([kvb[..., :nope], k_rope.expand(r, t, h, rd)], dim=-1)
    v = kvb[..., nope:]
    s = torch.einsum("rqhd,rkhd->rhqk", q, k) * softmax_scale(m)
    s = torch.where(valid[:, None], s, NEG)
    o = torch.einsum("rhqk,rkhd->rqhd", torch.softmax(s, dim=-1), v)
    mean = v[:, :prompt].sum(1, keepdim=True) / max_slots           # (R, 1, H, vd)
    o = torch.where(~valid.any(-1)[..., None, None], mean, o)
    return o.reshape(r, t, h * vd) @ w["wo"]


def swiglu(w: Dict, x):
    return (F.silu(x @ w["w_gate"]) * (x @ w["w_up"])) @ w["w_down"]


def capacity(group: int, experts: int, top_k: int, factor: float) -> int:
    cap = int(group * top_k / experts * factor)
    return max(4, (cap + 3) // 4 * 4)


def route(x, w: Dict, m: Dict, segments: List[Tuple[int, int, int]]):
    """(experts, gates, kept), each (R, T, k); ``segments`` (start, length,
    group) route a span of T in groups of ``group`` tokens."""
    e, k = m["num_experts"], m["top_k"]
    probs = torch.softmax(x @ w["router"], dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    if m["moe_renormalize"]:
        gates = gates / gates.sum(-1, keepdim=True)
    kept = torch.zeros_like(idx, dtype=torch.bool)
    r = x.shape[0]
    for start, length, g in segments:
        cap = capacity(g, e, k, m["capacity_factor"])
        sub = idx[:, start:start + length].reshape(r, length // g, g, k)
        used = torch.zeros(r, length // g, 1, e)
        keep = torch.zeros_like(sub, dtype=torch.bool)
        for c in range(k):
            one = F.one_hot(sub[..., c], e).float()
            slot = torch.cumsum(one, dim=2) - 1.0 + used
            ok = (slot < cap) & (one > 0)
            keep[..., c] = ok.any(-1)
            used = used + ok.float().sum(2, keepdim=True)
        kept[:, start:start + length] = keep.reshape(r, length, k)
    return idx, gates, kept


def moe(w: Dict, x, m: Dict, segments):
    idx, gates, kept = route(x, w, m, segments)
    y = torch.zeros_like(x)
    for e in range(m["num_experts"]):
        weight = (gates * ((idx == e) & kept)).sum(-1, keepdim=True)   # (R, T, 1)
        h = F.silu(x @ w["w_gate"][e]) * (x @ w["w_up"][e])
        y = y + weight * (h @ w["w_down"][e])
    return y + swiglu(w["shared"], x) if "shared" in w else y


def _fp32(tree):
    return {k: _fp32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def forward(params: Dict, m: Dict, tokens: torch.Tensor,
            offsets: Optional[torch.Tensor] = None, prompt: Optional[int] = None,
            max_slots: Optional[int] = None) -> torch.Tensor:
    """Logits (R, T, V_padded) of ``tokens`` (R, T).  Uncached by default;
    as served with ``prompt``: the first ``prompt`` tokens are a prompt
    left-padded by ``offsets`` (R,), routed in groups of the routing group
    (or the prompt's length), the rest fed back one a step, each routed
    alone, in a cache of ``max_slots`` slots."""
    with torch.no_grad(), exact_fp32():
        r, t = tokens.shape
        prompt = t if prompt is None else prompt
        max_slots = t if max_slots is None else max_slots
        off = torch.zeros(r, dtype=torch.long) if offsets is None else offsets
        pos = torch.arange(t)[None, :] - off[:, None]                  # (R, T)
        valid = (pos[:, None, :] <= pos[:, :, None]) & (pos[:, None, :] >= 0)
        g = min(m["moe_group_size"], prompt)
        segments = [(0, prompt, g)] + ([(prompt, t - prompt, 1)] if t > prompt else [])
        eps = m["norm_eps"]
        x = params["embed"]["embedding"][tokens].float()
        blocks = [("mlp", b) for b in params.get("dense_layers", [])]
        blocks += [("moe", b) for b in params["layers"]]
        for kind, block in blocks:
            w = _fp32(block)
            x = x + attention(w["attn"], rms_norm(x, w["attn_norm"], eps), m, pos, valid,
                              prompt, max_slots)
            h = rms_norm(x, w["mlp_norm"], eps)
            x = x + (swiglu(w["mlp"], h) if kind == "mlp" else moe(w["moe"], h, m, segments))
        logits = rms_norm(x, params["final_norm"].float(), eps) @ params["embed"]["lm_head"].float()
        logits[..., m["vocab_size"]:] = NEG
        return logits
