"""The plain reference of the decoder configurations: dense GQA, with or
without a sliding window, and deepseek-moe's leading dense layer, router, top-k,
capacity, routed and shared experts.

Plain PyTorch in float32 with TF32 off, written from the model's equations;
it imports nothing of the program.  It reads the weight tree the benchmark
made (``weights.make``), upcasting one layer at a time, so it fits beside
the weights.  ``fp8=True`` is the control: every product's two operands
rounded to float8 e4m3 (one scale a tensor) before it, the step below the
configurations' bfloat16.

Two ways in, one for each timed path:

* ``prefill_logits`` -- an uncached forward over one sequence at positions
  0..S-1 (causal, within the window), attention in query chunks;
* ``served_logits`` -- a served request as the server runs it: the prompt
  left-padded to the bucket's length, its positions shifted by the padding
  (``offset``), then the served tokens fed back one a step.  A padding
  query has no valid key and takes the mean of the ``max_seq`` cache slots'
  values, the unwritten ones zero; an MoE routes the prompt in groups of
  ``min(moe_group_size, bucket)`` tokens, each choice taking its expert's
  next free slot (choices in order, tokens in order) up to the capacity,
  and each decode token in a group of its own.

The semantics are those of the reference model the port follows (gates are
the top-k softmax probabilities renormalised; a token past its expert's
capacity loses that choice), listed in the configuration file.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

_NEG = -1e30
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32 inside the scope."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def q8(x: torch.Tensor, fp8: bool) -> torch.Tensor:
    """``x`` (fp32), or ``x`` rounded to float8 e4m3 under one scale."""
    if not fp8:
        return x
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    return q8(a, fp8) @ q8(b, fp8)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., T, H, D), pos (..., T): rotate the halves (llama)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = pos.float()[..., None] * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _fp32(tree) -> Dict:
    return {k: _fp32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def layer_order(params: Dict) -> List[Tuple[str, Dict]]:
    """(kind, block) in the order the layers run."""
    out = [("mlp", b) for b in params.get("dense_layers", [])]
    for b in params["layers"]:
        out.append(("moe" if "moe" in b else "mlp", b))
    return out


def swiglu(w: Dict, x: torch.Tensor, fp8: bool) -> torch.Tensor:
    return mm(F.silu(mm(x, w["w_gate"], fp8)) * mm(x, w["w_up"], fp8), w["w_down"], fp8)


def capacity(group: int, experts: int, top_k: int, factor: float) -> int:
    cap = int(group * top_k / experts * factor)
    return max(4, (cap + 3) // 4 * 4)


def route(x: torch.Tensor, w: Dict, m: Dict, segments: List[Tuple[int, int, int]], fp8: bool):
    """Top-k routing of x (R, T, d): (experts (R, T, k), gates (R, T, k),
    kept (R, T, k)).  ``segments`` are (start, length, group) spans of T,
    each routed in groups of ``group`` tokens with that group's capacity."""
    e, k = m["num_experts"], m["top_k"]
    probs = torch.softmax(mm(x, w["router"], fp8), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    kept = torch.zeros_like(idx, dtype=torch.bool)
    r = x.shape[0]
    for start, length, g in segments:
        cap = capacity(g, e, k, m.get("capacity_factor", 1.25))
        sub = idx[:, start:start + length].reshape(r, length // g, g, k)
        used = torch.zeros(r, length // g, 1, e, device=x.device)
        keep = torch.zeros_like(sub, dtype=torch.bool)
        for c in range(k):
            one = F.one_hot(sub[..., c], e).float()                   # (R, N, g, E)
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


def ffn(kind: str, w: Dict, x: torch.Tensor, m: Dict, segments, fp8: bool) -> torch.Tensor:
    """The block's second half: the dense SwiGLU, or the MoE."""
    return swiglu(w["mlp"], x, fp8) if kind == "mlp" else moe(w["moe"], x, m, segments, fp8)


def _qkv(w: Dict, x: torch.Tensor, m: Dict, pos: torch.Tensor, fp8: bool):
    r, t, _ = x.shape
    h, kv = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // h
    theta = m.get("rope_theta", 10000.0)
    q = rope(mm(x, w["wq"], fp8).reshape(r, t, h, hd), pos, theta)
    k = rope(mm(x, w["wk"], fp8).reshape(r, t, kv, hd), pos, theta)
    v = mm(x, w["wv"], fp8).reshape(r, t, kv, hd)
    return q, k, v


def _attend(q, k, v, valid, fp8: bool) -> torch.Tensor:
    """q (R, Lq, H, D) against k, v (R, Lk, Hkv, D) under ``valid`` (R, Lq,
    Lk); rows with no valid key come out NaN-free as a uniform mean."""
    r, lq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(r, lq, hkv, h // hkv, d)
    s = torch.einsum("rqkgd,rskd->rkgqs", q8(qg, fp8), q8(k, fp8)) / math.sqrt(d)
    s = torch.where(valid[:, None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("rkgqs,rskd->rqkgd", q8(p, fp8), q8(v, fp8))
    return o.reshape(r, lq, h * d)


def _window_ok(kpos, qpos, window: int):
    ok = (kpos <= qpos) & (kpos >= 0)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return ok


def prefill_logits(params: Dict, m: Dict, tokens: torch.Tensor, *, fp8: bool = False,
                   chunk: int = 2048, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (S, V) fp32 of an uncached forward over ``tokens`` (S,), or of
    the positions ``rows`` only."""
    with torch.no_grad(), exact_fp32():
        s = tokens.shape[0]
        pos = torch.arange(s, device=tokens.device)
        window = m.get("window", 0)
        eps = m.get("norm_eps", 1e-5)
        x = params["embed"]["embedding"][tokens].float()[None]         # (1, S, d)
        g = min(m.get("moe_group_size", 256), s)
        segments = [(0, s, g)]
        for kind, block in layer_order(params):
            w = _fp32(block)
            h = rms_norm(x, w["attn_norm"], eps)
            q, k, v = _qkv(w["attn"], h, m, pos, fp8)
            outs = []
            for c0 in range(0, s, chunk):
                c1 = min(s, c0 + chunk)
                lo = max(0, c0 - window + 1) if window > 0 else 0
                valid = _window_ok(pos[None, lo:c1], pos[c0:c1, None], window)
                outs.append(_attend(q[:, c0:c1], k[:, lo:c1], v[:, lo:c1], valid[None], fp8))
            x = x + mm(torch.cat(outs, dim=1), w["attn"]["wo"], fp8)
            x = x + ffn(kind, w, rms_norm(x, w["mlp_norm"], eps), m, segments, fp8)
            del w, h, q, k, v, outs
        x = x[0] if rows is None else x[0, rows]
        return unembed(params, m, rms_norm(x, params["final_norm"], eps), fp8)


def unembed(params: Dict, m: Dict, x: torch.Tensor, fp8: bool, block: int = 4096) -> torch.Tensor:
    head = params["embed"]["lm_head"]
    out = []
    for i in range(0, x.shape[0], block):
        out.append(mm(x[i:i + block], head.float(), fp8))
    logits = torch.cat(out)
    logits[:, m["vocab_size"]:] = _NEG
    return logits


def served_logits(params: Dict, m: Dict, prompts: torch.Tensor, offsets: torch.Tensor,
                  fed: torch.Tensor, max_seq: int, *, fp8: bool = False) -> torch.Tensor:
    """Logits (R, N + 1, V) fp32 that predict each served token of R
    requests: ``prompts`` (R, P) left-padded to the bucket's length P,
    ``offsets`` (R,) the padding of each, ``fed`` (R, N) the served tokens
    but the last, fed back at slots P..P+N-1 of a ``max_seq``-slot cache."""
    with torch.no_grad(), exact_fp32():
        r, plen = prompts.shape
        n = fed.shape[1]
        t = plen + n
        dev = prompts.device
        slots = torch.arange(t, device=dev)
        pos = slots[None, :] - offsets[:, None]                        # (R, T)
        window = m.get("window", 0)
        eps = m.get("norm_eps", 1e-5)
        valid = _window_ok(pos[:, None, :], pos[:, :, None], window)   # (R, T, T)
        empty = ~valid.any(-1)                                         # padding queries
        x = params["embed"]["embedding"][torch.cat([prompts, fed], dim=1)].float()
        g = min(m.get("moe_group_size", 256), plen)
        segments = [(0, plen, g)] + ([(plen, n, 1)] if n else [])
        for kind, block in layer_order(params):
            w = _fp32(block)
            h = rms_norm(x, w["attn_norm"], eps)
            q, k, v = _qkv(w["attn"], h, m, pos, fp8)
            o = _attend(q, k, v, valid, fp8)
            # a padding query (prefill) weighs the max_seq slots alike: the
            # prompt's values, then zeros
            hkv, hd = v.shape[2], v.shape[3]
            mean = (v[:, :plen].sum(1) / max_seq)                      # (R, Hkv, D)
            mean = mean[:, :, None].expand(r, hkv, q.shape[2] // hkv, hd).reshape(r, 1, -1)
            o = torch.where(empty[..., None], mean, o)
            x = x + mm(o, w["attn"]["wo"], fp8)
            x = x + ffn(kind, w, rms_norm(x, w["mlp_norm"], eps), m, segments, fp8)
            del w, h, q, k, v, o
        last = x[:, plen - 1:].reshape(r * (n + 1), -1)                 # the predicting slots
        out = unembed(params, m, rms_norm(last, params["final_norm"], eps), fp8)
        return out.reshape(r, n + 1, -1)
