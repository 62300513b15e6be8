"""Decoder-only LM, dense family (counterpart of ``repro.models.lm``).

The reference stacks each parameter on a leading layer axis and runs the
layers with ``lax.scan``; here the layers are a Python list of parameter
dicts run in a Python loop, and the per-layer KV caches are preallocated
tensors written in place.  ``decode_step`` takes the cache slot as an int
or as a 0-d int64 tensor on the model's device (the reference's traced
``pos``), so one captured CUDA graph serves every step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layers.attention import check_cache_write, gqa_cache
from repro_torch.layers.blocks import block_apply, block_params
from repro_torch.layers.embed import embed, embed_params, unembed
from repro_torch.layers.norms import rms_norm, rms_norm_params
from repro_torch.models.config import ModelConfig

Params = Dict
Cache = Dict


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.num_experts or cfg.first_dense_layers or cfg.attn_type != "gqa":
            raise NotImplementedError(
                f"{cfg.name}: only dense GQA decoders are ported so far")
        self.cfg = cfg
        self.kind = "attn_mlp"
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    # -- params -------------------------------------------------------------
    def init(self, generator: torch.Generator, device: DeviceLike = None) -> Params:
        """Random parameters with the reference's distributions: embedding
        N(0, 0.02), projections N(0, 1/d_in), norms 1.  Numbers are drawn on
        ``generator``'s device and moved to ``device`` (default ``cuda``)."""
        device = resolve_device(device)
        cfg = self.cfg
        return {
            "embed": embed_params(generator, cfg.vocab_size, cfg.d_model,
                                  cfg.tie_embeddings, self.dtype, device),
            "final_norm": rms_norm_params(cfg.d_model, device),
            "layers": [block_params(generator, cfg, self.kind, self.dtype, device)
                       for _ in range(cfg.num_layers)],
        }

    # -- forward ------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (logits (B, S, V_padded) fp32, aux loss)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for lp in params["layers"]:
            x, a, _ = block_apply(lp, x, cfg, self.kind, positions)
            aux = aux + a
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg.vocab_size), aux

    def loss(self, params: Params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Forward only (no backward kernels yet): mean token cross-entropy
        over ``batch["labels"]`` (-100 = ignore) plus 0.01 x the aux loss,
        and the parts as {"ce", "aux"}."""
        logits, aux = self.forward(params, batch["tokens"])
        ce = cross_entropy(logits, batch["labels"])
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device) -> Cache:
        return {"layers": [gqa_cache(self.cfg, batch, max_seq, self.dtype, device)
                           for _ in range(self.cfg.num_layers)]}

    def prefill(self, params: Params, cache: Cache, tokens: torch.Tensor,
                offsets: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """One pass over the prompt: writes K/V at slots [0, S) of ``cache``
        in place and returns (last-token logits (B, V_padded), cache).

        ``offsets`` (B,) marks per-row left-padding: row i's logical
        positions are arange(S) - offsets[i], so its padding slots sit at
        negative positions and attention masks them out."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        if offsets is not None:
            positions = positions[None, :] - offsets[:, None]
        return self._cached_forward(params, cache, tokens, positions, 0, offsets)

    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor,
                    pos, offsets: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B, 1); ``pos``: the absolute cache slot, an int or a
        0-d int64 tensor on the model's device.  Row i's logical query
        position is pos - offsets[i].  An int slot past the cache end
        raises; a tensor slot is not checked (that would wait for the
        device): check it with ``check_decode_pos`` first."""
        if offsets is not None:
            positions = pos - offsets[:, None]
        elif torch.is_tensor(pos):
            positions = pos.reshape(1)
        else:
            positions = torch.full((1,), pos, dtype=torch.int64, device=tokens.device)
        return self._cached_forward(params, cache, tokens, positions, pos, offsets)

    def check_decode_pos(self, cache: Cache, pos: int) -> None:
        """Raise where a decode step at slot ``pos`` (an int on the host)
        would write past the cache end."""
        check_cache_write(self.cfg, cache["layers"][0], pos, 1)

    def _cached_forward(self, params: Params, cache: Cache, tokens: torch.Tensor,
                        positions: torch.Tensor, pos,
                        offsets: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Cache]:
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        for lp, lc in zip(params["layers"], cache["layers"]):
            x, _, _ = block_apply(lp, x, cfg, self.kind, positions, lc, pos, offsets)
        # only the last position's logits are returned: unembed just that row
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg.vocab_size)[:, -1], cache


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits fp32 (B, S, V); labels (B, S) with -100 = ignore."""
    valid = labels >= 0
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (torch.logsumexp(logits, dim=-1) - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)
