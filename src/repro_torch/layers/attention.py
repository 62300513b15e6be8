"""Attention layers with their caches: GQA (covers MHA, MQA and sliding
windows) and MLA (latent-compressed KV: minicpm3, DeepSeek-V2-Lite).

Counterpart of ``repro.layers.attention``.  Two attention cores for GQA,
chosen by ``cfg.attn_impl`` as in the reference:

* ``xla`` -- the reference's chunked masked einsum and softmax in plain
  PyTorch, with fp32 statistics; a call with one query per row on the
  card (every cached decode step) runs the same function in the split-KV
  decode kernel (``kernels.decode_attention``), which reads the bf16 cache
  in place and only its valid slots;
* ``flash`` -- the flash-attention kernel (K2, ``kernels.flash_attention``),
  on the uncached path only: it puts query i and key j at positions i and
  j, and has no mask for the per-row offsets of a cached serving batch.

The q/k/v/o projections go through ``linear`` and so through the Z-order
matmul kernel.

MLA, as in the reference, never calls ``mha``.  Uncached, it expands the
latent into per-head keys and values (``wkv_b`` through ``linear``) and
attends with ``chunked_attention``.  Cached, it keeps the latent
``{"c_kv", "k_rope"}``.  A decode step attends in the latent space
(``latent_core``): ``w_uk`` folded into the query, the shared rope key
added, the offsets mask, ``w_uv`` applied after, all in fp32 einsums (the
reference's absorbed decode, which runs outside any Pallas kernel).  A
cached write of more than one token (the serving prefill) expands every
slot of the latent cache into per-head keys and values (an fp32 einsum
through ``wkv_b``) and attends with ``chunked_attention`` a query chunk at
a time, so no (B, S, H, T) score tensor is built whole; the reference
attends in the latent space there too, the same function.  ``wkv_b``
takes no kernel launch on either cached path.  DeepSeek-V2-Lite's query
comes from one direct projection (``q_lora_rank`` 0) and its RoPE and
softmax scale follow YaRN (``cfg.yarn``).

The KV cache is preallocated and written in place (the reference returns
a new cache from ``dynamic_update_slice``); a write past the cache end
raises, where the reference clamps silently.  So does a write of more
than one token into a rolling (sliding-window) cache: the reference's
slot positions are right only for one token at a time (a multi-token
prefill masks every key but slot 0), and the port refuses rather than
give that answer.

The cache slot ``pos`` is a Python int or, as the reference traces it, a
0-d int64 tensor on the model's device: then the write is an
``index_copy_`` at ``pos`` (``pos % W`` when rolling) and the rolling
slots' key positions are computed on the device, so one CUDA graph serves
every decode step.  A tensor ``pos`` is not checked (that would wait for
the device): its callers check it on the host first
(``check_cache_write``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import decode_attention
from repro_torch.kernels.flash_attention import mha
from repro_torch.models.config import ModelConfig
from .linear import linear, linear_params
from .norms import rms_norm, rms_norm_params
from .rope import apply_rope, yarn_mscale

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]

_NEG = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window: int,
          causal: bool = True) -> torch.Tensor:
    """(Lq, Skv) -- or, with per-row positions, (B, Lq, Skv) -- boolean
    mask: causal + optional sliding window.  Negative key positions
    (left-padding and unwritten rolling slots) are always invalid."""
    if causal:
        m = kpos[..., None, :] <= qpos[..., :, None]
    else:
        shape = torch.broadcast_shapes(qpos[..., :, None].shape, kpos[..., None, :].shape)
        m = torch.ones(shape, dtype=torch.bool, device=qpos.device)
    m = m & (kpos >= 0)[..., None, :]
    if window > 0:
        m = m & (kpos[..., None, :] > qpos[..., :, None] - window)
    return m


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qpos, kpos,
          window: int, scale: float, causal: bool = True,
          probs_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q: (B, L, Hkv, G, Dk); k: (B, S, Hkv, Dk); v: (B, S, Hkv, Dv).

    Products accumulate in fp32 from the operands' values (bf16 values are
    exact in fp32); ``probs_dtype`` rounds the probabilities before the PV
    product as the reference does.  A row with no valid key gets a uniform
    softmax over -1e30 scores, as in the reference."""
    s = torch.einsum("blhgd,bshd->blhgs", q.float(), k.float()) * scale
    m = _mask(qpos, kpos, window, causal)
    if m.ndim == 2:
        m = m[None]
    s = torch.where(m[:, :, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1).to(probs_dtype).float()
    o = torch.einsum("blhgs,bshd->blhgd", p, v.to(probs_dtype).float())
    return o.to(v.dtype)


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    qpos: torch.Tensor, kpos: torch.Tensor,
    *, window: int = 0, chunk: int = 1024, scale: Optional[float] = None,
    causal: bool = True, probs_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """q: (B, Sq, H, Dk) grouped against k/v: (B, Skv, Hkv, D*).  Loops
    over query chunks so the score matrix is O(B*chunk*H*Skv).

    One query per row (a decode step) with fp32 probabilities goes to the
    split-KV decode kernel where it takes the tensors
    (``kernels.decode_attention.takes``: CUDA bf16, no grad, head dims it
    compiles): the same function, reading the cache in place and only its
    valid slots.  Every other call runs ``_sdpa``."""
    b, sq, h, dk = q.shape
    _, skv, hkv, dv = v.shape
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = q.reshape(b, sq, hkv, g, dk)
    if sq == 1 and probs_dtype == torch.float32 and decode_attention.takes(qg, k, v):
        o = decode_attention.decode_attention(qg, k, v, qpos, kpos, window, scale, causal)
        return o.reshape(b, sq, h, dv)
    if sq <= chunk:
        o = _sdpa(qg, k, v, qpos, kpos, window, scale, causal, probs_dtype)
        return o.reshape(b, sq, h, dv)
    if sq % chunk:
        raise ValueError(f"query length {sq} is not a multiple of chunk {chunk}")
    outs = []
    for c0 in range(0, sq, chunk):
        pc = qpos[..., c0:c0 + chunk]
        outs.append(_sdpa(qg[:, c0:c0 + chunk], k, v, pc, kpos, window, scale,
                          causal, probs_dtype))
    return torch.cat(outs, dim=1).reshape(b, sq, h, dv)


def gqa_params(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": linear_params(generator, d, h * hd, dtype, device),
        "wk": linear_params(generator, d, kv * hd, dtype, device),
        "wv": linear_params(generator, d, kv * hd, dtype, device),
        "wo": linear_params(generator, h * hd, d, dtype, device),
    }


def check_cache_write(cfg: ModelConfig, cache: Cache, pos: int, s: int) -> None:
    """Raise where writing ``s`` tokens at slot ``pos`` would go wrong: a
    multi-token write into a rolling window cache, or a write past the
    cache end.  ``cache`` is a GQA cache ``{"k", "v"}`` or an MLA latent
    cache ``{"c_kv", "k_rope"}`` (never rolling, as in the reference)."""
    latent = "c_kv" in cache
    s_cache = cache["c_kv" if latent else "k"].shape[1]
    rolling = not latent and cfg.window > 0 and s_cache == cfg.window
    if rolling and s > 1:
        raise ValueError(f"a write of {s} tokens into a rolling {s_cache}-slot "
                         f"window cache: only one token at a time is positioned "
                         f"right; prefill one token, then decode")
    slot = pos % s_cache if rolling else pos
    if slot < 0 or slot + s > s_cache:
        raise ValueError(f"cache write of {s} slots at {slot} overruns the "
                         f"{s_cache}-slot cache")


def gqa_attention(
    p: Params, x: torch.Tensor, cfg: ModelConfig,
    positions: torch.Tensor,
    cache: Optional[Cache] = None,
    pos=None,
    causal: bool = True,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, d).  Without a cache: training / uncached prefill.  With
    one: write this step's K/V at slot ``pos`` (an int, or a 0-d int64
    tensor on x's device, unchecked) in place, then attend over the whole
    cache (prefill with ``pos`` 0, or decode with S == 1).

    ``offsets`` (B,) shifts each row's logical positions for left-padded
    serving batches: cache slot j holds row i's position j - offsets[i], so
    padding slots sit at negative positions and the mask removes them.
    ``positions`` is then the matching per-row (B, S) query positions."""
    with obs.span("layer.attention"):
        b, s, _ = x.shape
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = linear(x, p["wq"]).reshape(b, s, h, hd)
        k = linear(x, p["wk"]).reshape(b, s, kv, hd)
        v = linear(x, p["wv"]).reshape(b, s, kv, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

        pdt = torch.bfloat16 if cfg.attn_probs_dtype == "bf16" else torch.float32
        if cache is None and cfg.attn_impl == "flash":
            if positions.shape != (s,):
                raise ValueError("the flash route takes 1-D positions 0..S-1: the kernel "
                                 "puts query i and key j at positions i and j")
            if pdt != torch.float32:
                raise ValueError("the flash route keeps the probabilities in fp32; "
                                 "attn_probs_dtype='bf16' needs attn_impl='xla'")
            with obs.span("layer.attention_core"):
                o = mha(q, k, v, causal=causal, window=cfg.window)
        elif cache is None:
            with obs.span("layer.attention_core"):
                o = chunked_attention(q, k, v, positions, positions, window=cfg.window,
                                      chunk=cfg.attn_chunk, causal=causal, probs_dtype=pdt)
        else:
            s_cache = cache["k"].shape[1]
            rolling = cfg.window > 0 and s_cache == cfg.window
            if torch.is_tensor(pos):
                if rolling and s > 1:
                    check_cache_write(cfg, cache, 0, s)
                slot = torch.remainder(pos, s_cache) if rolling else pos
                rows = slot + torch.arange(s, device=x.device)
                cache["k"].index_copy_(1, rows, k)
                cache["v"].index_copy_(1, rows, v)
            else:
                check_cache_write(cfg, cache, pos, s)
                slot = pos % s_cache if rolling else pos
                cache["k"][:, slot:slot + s] = k
                cache["v"][:, slot:slot + s] = v
            idx = torch.arange(s_cache, device=x.device)
            if rolling:
                # slot i holds position pos - ((pos - i) mod W); invalid (< 0)
                # slots fail the causal check against qpos = pos
                kpos = pos - torch.remainder(pos - idx, s_cache)
            else:
                kpos = idx
            if offsets is not None:
                kpos = kpos[None, :] - offsets[:, None]
            with obs.span("layer.attention_core"):
                o = chunked_attention(q, cache["k"], cache["v"], positions, kpos,
                                      window=cfg.window, chunk=cfg.attn_chunk,
                                      probs_dtype=pdt)
        o = linear(o.reshape(b, s, h * hd), p["wo"])
        return o, cache


def gqa_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
              device) -> Cache:
    s = min(max_seq, cfg.window) if cfg.window > 0 else max_seq
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (minicpm3, DeepSeek-V2-Lite): latent-compressed KV
# ---------------------------------------------------------------------------


def mla_params(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, device) -> Params:
    """The query through a LoRA (``wq_a``, ``q_norm``, ``wq_b``), or with
    ``q_lora_rank`` 0 through one direct projection ``wq`` (DeepSeek-V2-Lite)."""
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if qr:
        p = {"wq_a": linear_params(generator, d, qr, dtype, device),
             "q_norm": rms_norm_params(qr, device),
             "wq_b": linear_params(generator, qr, h * (nope + rope), dtype, device)}
    else:
        p = {"wq": linear_params(generator, d, h * (nope + rope), dtype, device)}
    return {
        **p,
        "wkv_a": linear_params(generator, d, kvr + rope, dtype, device),
        "kv_norm": rms_norm_params(kvr, device),
        "wkv_b": linear_params(generator, kvr, h * (nope + vd), dtype, device),
        "wo": linear_params(generator, h * vd, d, dtype, device),
    }


def mla_scale(cfg: ModelConfig) -> float:
    """The softmax scale: 1 / sqrt(nope + rope), times YaRN's
    ``mscale(factor, mscale_all_dim) ** 2`` where the config sets it
    (DeepSeek-V2's attention)."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    if cfg.yarn is not None and cfg.yarn.mscale_all_dim:
        scale *= yarn_mscale(cfg.yarn.factor, cfg.yarn.mscale_all_dim) ** 2
    return scale


def _mla_q(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, s, _ = x.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = linear(rms_norm(linear(x, p["wq_a"]), p["q_norm"], cfg.norm_eps), p["wq_b"])
    else:
        q = linear(x, p["wq"])
    q = q.reshape(b, s, cfg.num_heads, nope + rope)
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta, cfg.yarn)


def _mla_latent(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    kvr = cfg.kv_lora_rank
    kv = linear(x, p["wkv_a"])
    c_kv = rms_norm(kv[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], positions, cfg.rope_theta,
                        cfg.yarn)[:, :, 0, :]
    return c_kv, k_rope


def _mla_count(route: str) -> None:
    if obs.enabled():
        obs.counter("layer.mla.calls").inc(route=route)


def _latent_kpos(t: int, offsets: Optional[torch.Tensor], device) -> torch.Tensor:
    """The logical positions of a latent cache's ``t`` slots: (T,), or
    (B, T) shifted by each row's left padding (padding slots < 0)."""
    kpos = torch.arange(t, device=device)
    return kpos if offsets is None else kpos[None, :] - offsets[:, None]


def latent_core(q_nope: torch.Tensor, q_rope: torch.Tensor, cache: Cache,
                wkv_b: torch.Tensor, positions: torch.Tensor,
                offsets: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """The absorbed attention over the whole latent cache (a decode step):
    ``w_uk`` folded into the query, the scores against the latent and the
    shared rope key, the offsets mask, the softmax, the weighted latent and
    ``w_uv``, in fp32 einsums.  q_nope (B, S, H, nope), q_rope (B, S, H,
    rope) -> (B, S, H, v_head_dim) fp32."""
    with obs.span("layer.mla.latent_core"):
        h, nope = q_nope.shape[2], q_nope.shape[3]
        cc, cr = cache["c_kv"].float(), cache["k_rope"].float()
        kvr = cc.shape[-1]
        # wkv_b's columns are per-head blocks of (nope + vd), as the
        # expanded path's reshape reads them
        w_b = wkv_b.reshape(kvr, h, -1).float()
        w_uk, w_uv = w_b[:, :, :nope], w_b[:, :, nope:]
        q_c = torch.einsum("bshn,lhn->bshl", q_nope.float(), w_uk)   # w_uk folded into q
        sc = torch.einsum("bshl,btl->bsht", q_c, cc)
        sc = sc + torch.einsum("bshr,btr->bsht", q_rope.float(), cr)
        sc = sc * scale
        kpos = _latent_kpos(cc.shape[1], offsets, cc.device)
        if offsets is not None:
            # left-padding slots (< 0) are masked, as GQA's kpos >= 0
            valid = (kpos[:, None, :] <= positions[:, :, None]) & (kpos[:, None, :] >= 0)
            sc = torch.where(valid[:, :, None, :], sc, _NEG)               # (B, S, T)
        else:
            valid = kpos[None, :] <= positions[:, None]                     # (S, T)
            sc = torch.where(valid[None, :, None, :], sc, _NEG)
        pr = torch.softmax(sc, dim=-1)
        att_c = torch.einsum("bsht,btl->bshl", pr, cc)
        return torch.einsum("bshl,lhv->bshv", att_c, w_uv)


def _head_kv(kvb: torch.Tensor, k_rope: torch.Tensor, nope: int):
    """Per-head keys (B, T, H, nope + rope), the shared rope key beside
    each head's, and values (B, T, H, vd) from the latent's expansion
    ``kvb`` (B, T, H, nope + vd)."""
    b, t, h, _ = kvb.shape
    k = torch.cat([kvb[..., :nope], k_rope[:, :, None, :].expand(b, t, h, k_rope.shape[-1])],
                  dim=-1)
    return k, kvb[..., nope:]


def mla_attention(
    p: Params, x: torch.Tensor, cfg: ModelConfig,
    positions: torch.Tensor,
    cache: Optional[Cache] = None,
    pos=None,
    offsets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, d).  Without a cache: the expanded path.  With one: write
    this step's latent at slot ``pos`` (an int, or a 0-d int64 tensor on
    x's device, unchecked) in place and attend over the whole latent cache:
    one token a row (a decode step) by the absorbed path (``latent_core``),
    more (a serving prefill) by the expanded path over the cache, query
    chunk by query chunk.  ``offsets`` and ``positions`` as in
    ``gqa_attention``.  Counted in ``layer.mla.calls{route}``: ``uncached``,
    ``absorbed``, ``cached_prefill``."""
    with obs.span("layer.attention"):
        b, s, _ = x.shape
        h = cfg.num_heads
        nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
        scale = mla_scale(cfg)
        pdt = torch.bfloat16 if cfg.attn_probs_dtype == "bf16" else torch.float32
        q_nope, q_rope = _mla_q(p, x, cfg, positions)
        c_kv, k_rope = _mla_latent(p, x, cfg, positions)

        if cache is None:
            _mla_count("uncached")
            # expanded path: materialise per-head K/V from the latent
            k, v = _head_kv(linear(c_kv, p["wkv_b"]).reshape(b, s, h, nope + vd), k_rope, nope)
            q = torch.cat([q_nope, q_rope], dim=-1)
            with obs.span("layer.attention_core"):
                o = chunked_attention(q, k, v, positions, positions, chunk=cfg.attn_chunk,
                                      scale=scale, probs_dtype=pdt)
        else:
            if torch.is_tensor(pos):
                rows = pos + torch.arange(s, device=x.device)
                cache["c_kv"].index_copy_(1, rows, c_kv)
                cache["k_rope"].index_copy_(1, rows, k_rope)
            else:
                check_cache_write(cfg, cache, pos, s)
                cache["c_kv"][:, pos:pos + s] = c_kv
                cache["k_rope"][:, pos:pos + s] = k_rope
            if s == 1:
                _mla_count("absorbed")
                with obs.span("layer.attention_core"):
                    o = latent_core(q_nope, q_rope, cache, p["wkv_b"], positions, offsets,
                                    scale).to(x.dtype)
            else:
                _mla_count("cached_prefill")
                with obs.span("layer.attention_core"):
                    # every slot expanded in fp32 (an einsum, as the absorbed
                    # path multiplies wkv_b), then attended a query chunk at a time
                    cc = cache["c_kv"].float()
                    kvb = torch.einsum("btl,lhx->bthx", cc,
                                       p["wkv_b"].reshape(cc.shape[-1], h, -1).float())
                    k, v = _head_kv(kvb, cache["k_rope"].float(), nope)
                    kpos = _latent_kpos(k.shape[1], offsets, x.device)
                    q = torch.cat([q_nope, q_rope], dim=-1)
                    o = chunked_attention(q, k, v, positions, kpos, chunk=cfg.attn_chunk,
                                          scale=scale).to(x.dtype)
        o = linear(o.reshape(b, s, h * vd), p["wo"])
        return o, cache


def mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
              device) -> Cache:
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_dim), dtype=dtype, device=device),
    }
