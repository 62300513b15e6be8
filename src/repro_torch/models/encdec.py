"""Encoder-decoder LM (the seamless-m4t backbone).

Counterpart of ``repro.models.encdec``.  The modality frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings
(B, S_src, d).  Encoder blocks are non-causal self-attention + MLP;
decoder blocks add causal self-attention (cached at decode) and
cross-attention over the encoder output (its K/V cached once by
``prefill_cross``).  Every projection goes through ``linear`` and so
through the Z-order matmul kernel (K1); with ``attn_impl="flash"`` the
encoder's and ``decode_train``'s self-attention run on the flash-attention
kernel (K2, non-causal in the encoder); cross-attention is always the
chunked core, as in the reference.

The reference stacks each layer's parameters on a leading axis; here
``enc_layers`` and ``dec_layers`` are lists of per-layer dicts, and the
cache is ``{"self": [GQA K/V per layer], "cross": [{"k", "v"} per layer]}``,
preallocated and written in place.  The model's inference path is
``encode`` -> ``prefill_cross`` -> ``decode_step``.  The serving runtime
(``generate``, ``Server``) has no source to encode: it runs ``decode_step``
from ``init_cache``'s zero cross cache, as the reference's ``generate``
does (``ROADMAP.md`` §3), so its tokens ignore any source.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layers.attention import (check_cache_write, chunked_attention, gqa_attention,
                                          gqa_cache, gqa_params)
from repro_torch.layers.embed import embed, embed_params, unembed
from repro_torch.layers.linear import linear, linear_params
from repro_torch.layers.mlp import mlp, mlp_params
from repro_torch.layers.norms import rms_norm, rms_norm_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import cross_entropy, decode_positions, remat

Params = Dict
Cache = Dict


def _xattn_params(generator, cfg: ModelConfig, dtype, device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": linear_params(generator, d, h * hd, dtype, device),
            "wk": linear_params(generator, d, kv * hd, dtype, device),
            "wv": linear_params(generator, d, kv * hd, dtype, device),
            "wo": linear_params(generator, h * hd, d, dtype, device)}


def _cross_kv(p: Params, memory: torch.Tensor, cfg: ModelConfig):
    b, ss, _ = memory.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return (linear(memory, p["wk"]).reshape(b, ss, kv, hd),
            linear(memory, p["wv"]).reshape(b, ss, kv, hd))


def _cross_attention(p: Params, x: torch.Tensor, memory: Optional[torch.Tensor],
                     cfg: ModelConfig, cached_kv: Optional[Dict] = None) -> torch.Tensor:
    """x: (B, S_t, d) queries; memory: (B, S_s, d) encoder output, or the
    cached K/V."""
    b, st, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = linear(x, p["wq"]).reshape(b, st, h, hd)
    if cached_kv is None:
        k, v = _cross_kv(p, memory, cfg)
    else:
        k, v = cached_kv["k"], cached_kv["v"]
    qpos = torch.arange(st, device=x.device)
    kpos = torch.arange(k.shape[1], device=x.device)
    o = chunked_attention(q, k, v, qpos, kpos, chunk=cfg.attn_chunk, causal=False)
    return linear(o.reshape(b, st, h * hd), p["wo"])


def _enc_block_params(generator, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    return {"attn_norm": rms_norm_params(d, device),
            "attn": gqa_params(generator, cfg, dtype, device),
            "mlp_norm": rms_norm_params(d, device),
            "mlp": mlp_params(generator, d, cfg.d_ff, dtype, device)}


def _dec_block_params(generator, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    return {"self_norm": rms_norm_params(d, device),
            "self_attn": gqa_params(generator, cfg, dtype, device),
            "cross_norm": rms_norm_params(d, device),
            "cross_attn": _xattn_params(generator, cfg, dtype, device),
            "mlp_norm": rms_norm_params(d, device),
            "mlp": mlp_params(generator, d, cfg.d_ff, dtype, device)}


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def init(self, generator: torch.Generator, device: DeviceLike = None) -> Params:
        device = resolve_device(device)
        cfg, dt = self.cfg, self.dtype
        return {
            "embed": embed_params(generator, cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                                  dt, device),
            "enc_layers": [_enc_block_params(generator, cfg, dt, device)
                           for _ in range(cfg.enc_layers)],
            "dec_layers": [_dec_block_params(generator, cfg, dt, device)
                           for _ in range(cfg.dec_layers)],
            "enc_norm": rms_norm_params(cfg.d_model, device),
            "final_norm": rms_norm_params(cfg.d_model, device),
        }

    def param_stacks(self) -> List[Tuple[str, int]]:
        return [("enc_layers", self.cfg.enc_layers), ("dec_layers", self.cfg.dec_layers)]

    # -- uncached -------------------------------------------------------------
    def _enc_block(self, lp: Params, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        a, _ = gqa_attention(lp["attn"], h, cfg, positions, causal=False)
        x = x + a
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return x + mlp(lp["mlp"], h)

    def encode(self, params: Params, src_embed: torch.Tensor) -> torch.Tensor:
        """src_embed: (B, S_src, d) frame embeddings -> the normed encoder
        output (B, S_src, d) in the model's type."""
        cfg = self.cfg
        x = src_embed.to(self.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        block = remat(self._enc_block, cfg)
        for lp in params["enc_layers"]:
            x = block(lp, x, positions)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _dec_block(self, lp: Params, x, memory, positions):
        cfg = self.cfg
        h = rms_norm(x, lp["self_norm"], cfg.norm_eps)
        a, _ = gqa_attention(lp["self_attn"], h, cfg, positions, causal=True)
        x = x + a
        h = rms_norm(x, lp["cross_norm"], cfg.norm_eps)
        x = x + _cross_attention(lp["cross_attn"], h, memory, cfg)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return x + mlp(lp["mlp"], h)

    def decode_train(self, params: Params, memory: torch.Tensor,
                     tgt_tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder over ``tgt_tokens`` (B, S_t) against the
        encoder output -> logits (B, S_t, V_padded) fp32."""
        cfg = self.cfg
        x = embed(params["embed"], tgt_tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        block = remat(self._dec_block, cfg)
        for lp in params["dec_layers"]:
            x = block(lp, x, memory, positions)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg.vocab_size)

    def forward(self, params: Params, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: {"src_embed": (B, S_src, d), "tokens": (B, S_t)}."""
        memory = self.encode(params, batch["src_embed"])
        logits = self.decode_train(params, memory, batch["tokens"])
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(self, params: Params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        logits, _ = self.forward(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce}

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device, src_len: int = 1024) -> Cache:
        """Per decoder layer a self-attention K/V of ``max_seq`` slots and a
        zero cross K/V of ``src_len`` source positions."""
        cfg = self.cfg
        shape = (batch, src_len, cfg.num_kv_heads, cfg.head_dim)
        return {
            "self": [gqa_cache(cfg, batch, max_seq, self.dtype, device)
                     for _ in range(cfg.dec_layers)],
            "cross": [{"k": torch.zeros(shape, dtype=self.dtype, device=device),
                       "v": torch.zeros(shape, dtype=self.dtype, device=device)}
                      for _ in range(cfg.dec_layers)],
        }

    def prefill_cross(self, params: Params, memory: torch.Tensor, cache: Cache) -> Cache:
        """Fill the cross-attention K/V from the encoder output: in place
        where the cache has ``memory``'s source length, else (as the
        reference, which returns the new K/V whatever their length) by
        replacing each layer's tensors."""
        for i, lp in enumerate(params["dec_layers"]):
            k, v = _cross_kv(lp["cross_attn"], memory, self.cfg)
            layer = cache["cross"][i]
            if layer["k"].shape == k.shape:
                layer["k"].copy_(k)
                layer["v"].copy_(v)
            else:
                cache["cross"][i] = {"k": k, "v": v}
        return cache

    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B, 1) at self-attention slot ``pos`` (an int, or a 0-d
        int64 tensor on the device, unchecked: ``check_decode_pos``)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        positions = decode_positions(pos, tokens.device)
        for lp, sc, cc in zip(params["dec_layers"], cache["self"], cache["cross"]):
            h = rms_norm(x, lp["self_norm"], cfg.norm_eps)
            a, _ = gqa_attention(lp["self_attn"], h, cfg, positions, sc, pos)
            x = x + a
            h = rms_norm(x, lp["cross_norm"], cfg.norm_eps)
            x = x + _cross_attention(lp["cross_attn"], h, None, cfg, cached_kv=cc)
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + mlp(lp["mlp"], h)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg.vocab_size)[:, 0], cache

    def check_decode_pos(self, cache: Cache, pos: int) -> None:
        """Raise where a step at slot ``pos`` would write past the decoder's
        self-attention cache."""
        check_cache_write(self.cfg, cache["self"][0], pos, 1)
