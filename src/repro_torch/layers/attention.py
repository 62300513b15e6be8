"""GQA attention (covers MHA, MQA and sliding windows) with a KV cache.

Counterpart of the GQA half of ``repro.layers.attention``.  Two attention
cores, chosen by ``cfg.attn_impl`` as in the reference:

* ``xla`` -- the reference's chunked masked einsum and softmax in plain
  PyTorch, with fp32 statistics;
* ``flash`` -- the flash-attention kernel (K2, ``kernels.flash_attention``),
  on the uncached path only: it puts query i and key j at positions i and
  j, and has no mask for the per-row offsets of a cached serving batch.

The q/k/v/o projections go through ``linear`` and so through the Z-order
matmul kernel.  MLA waits for its slice.

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

from repro_torch.kernels.flash_attention import mha
from repro_torch.models.config import ModelConfig
from .linear import linear, linear_params
from .rope import apply_rope

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
    over query chunks so the score matrix is O(B*chunk*H*Skv)."""
    b, sq, h, dk = q.shape
    _, skv, hkv, dv = v.shape
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = q.reshape(b, sq, hkv, g, dk)
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
    cache end."""
    s_cache = cache["k"].shape[1]
    rolling = cfg.window > 0 and s_cache == cfg.window
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
        o = mha(q, k, v, causal=causal, window=cfg.window)
    elif cache is None:
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
        o = chunked_attention(q, cache["k"], cache["v"], positions, kpos,
                              window=cfg.window, chunk=cfg.attn_chunk, probs_dtype=pdt)
    o = linear(o.reshape(b, s, h * hd), p["wo"])
    return o, cache


def gqa_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
              device) -> Cache:
    s = min(max_seq, cfg.window) if cfg.window > 0 else max_seq
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
