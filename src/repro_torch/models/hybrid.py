"""Zamba2-style hybrid: a Mamba-2 backbone and one *shared* attention block.

Counterpart of ``repro.models.hybrid``.  The ``num_layers`` Mamba layers run
in groups of ``shared_attn_every``; after each group the single shared
transformer block (the same parameters every time, as in Zamba/Zamba2) runs
on concat(hidden, original embedding) projected back to d_model by
``shared_in``.  Each of its invocations keeps its own KV cache.

The reference stacks the Mamba layers on a leading axis and regroups them
into (groups, per group); here ``params["mamba_layers"]`` is a flat list in
the same order (layer i sits in group i // shared_attn_every).  Caches are
preallocated and written in place: ``cache["mamba"]`` one conv + SSM state
per layer, ``cache["shared"]`` one GQA K/V per group.  There is no
``prefill``, as in the reference: the serving runtime feeds the prompt
through ``decode_step`` one token at a time (``runtime.serve.prefill``), and
the model takes no per-row position offsets, so a left-padded row runs its
pad tokens through the recurrence (``ROADMAP.md`` §3).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layers.attention import check_cache_write, gqa_attention, gqa_cache, gqa_params
from repro_torch.layers.blocks import block_apply, block_params
from repro_torch.layers.embed import embed, embed_params, unembed
from repro_torch.layers.linear import linear, linear_params
from repro_torch.layers.mamba2 import mamba2_cache
from repro_torch.layers.mlp import mlp, mlp_params
from repro_torch.layers.norms import rms_norm, rms_norm_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import cross_entropy, decode_positions, remat

Params = Dict
Cache = Dict


class HybridLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.shared_attn_every <= 0 or cfg.num_layers % cfg.shared_attn_every:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split into groups "
                             f"of shared_attn_every={cfg.shared_attn_every}")
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.n_groups = cfg.num_layers // cfg.shared_attn_every

    def init(self, generator: torch.Generator, device: DeviceLike = None) -> Params:
        """Random parameters with the reference's distributions, drawn on
        ``generator``'s device and moved to ``device`` (default ``cuda``)."""
        device = resolve_device(device)
        cfg, dt, d = self.cfg, self.dtype, self.cfg.d_model
        return {
            "embed": embed_params(generator, cfg.vocab_size, d, cfg.tie_embeddings, dt,
                                  device),
            "mamba_layers": [block_params(generator, cfg, "mamba", dt, device)
                             for _ in range(cfg.num_layers)],
            "shared_in": linear_params(generator, 2 * d, d, dt, device),
            "shared": {"attn_norm": rms_norm_params(d, device),
                       "attn": gqa_params(generator, cfg, dt, device),
                       "mlp_norm": rms_norm_params(d, device),
                       "mlp": mlp_params(generator, d, cfg.d_ff, dt, device)},
            "final_norm": rms_norm_params(d, device),
        }

    def param_stacks(self) -> List[Tuple[str, int]]:
        return [("mamba_layers", self.cfg.num_layers)]

    def _groups(self, layers: list) -> List[list]:
        per = self.cfg.shared_attn_every
        return [layers[g * per:(g + 1) * per] for g in range(self.n_groups)]

    def _shared_block(self, params: Params, x, x0, positions, cache=None, pos=None):
        cfg = self.cfg
        h = linear(torch.cat([x, x0], dim=-1), params["shared_in"])
        sp = params["shared"]
        hn = rms_norm(h, sp["attn_norm"], cfg.norm_eps)
        a, _ = gqa_attention(sp["attn"], hn, cfg, positions, cache, pos)
        h = h + a
        hn = rms_norm(h, sp["mlp_norm"], cfg.norm_eps)
        h = h + mlp(sp["mlp"], hn)
        return x + h

    def _mamba(self, lp: Params, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return block_apply(lp, x, self.cfg, "mamba", positions)[0]

    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (logits (B, S, V_padded) fp32, aux 0)."""
        cfg = self.cfg
        x0 = embed(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        block = remat(self._mamba, cfg)
        x = x0
        for group in self._groups(params["mamba_layers"]):
            for lp in group:
                x = block(lp, x, positions)
            x = self._shared_block(params, x, x0, positions)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return unembed(params["embed"], x, cfg.vocab_size), aux

    def loss(self, params: Params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        logits, _ = self.forward(params, batch["tokens"])
        ce = cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce}

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device) -> Cache:
        cfg = self.cfg
        return {"mamba": [mamba2_cache(cfg, batch, self.dtype, device)
                          for _ in range(cfg.num_layers)],
                "shared": [gqa_cache(cfg, batch, max_seq, self.dtype, device)
                           for _ in range(self.n_groups)]}

    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B, 1) at cache slot ``pos`` (an int, or a 0-d int64
        tensor on the model's device, unchecked: ``check_decode_pos``)
        -> (logits (B, V_padded), cache), the states written in place."""
        cfg = self.cfg
        x0 = embed(params["embed"], tokens)
        positions = decode_positions(pos, tokens.device)
        x = x0
        groups = zip(self._groups(params["mamba_layers"]), self._groups(cache["mamba"]),
                     cache["shared"])
        for layers, caches, shared in groups:
            for lp, lc in zip(layers, caches):
                x, _, _ = block_apply(lp, x, cfg, "mamba", positions, lc, pos)
            x = self._shared_block(params, x, x0, positions, shared, pos)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg.vocab_size)[:, 0], cache

    def check_decode_pos(self, cache: Cache, pos: int) -> None:
        """Raise where a step at slot ``pos`` would write past the shared
        block's K/V cache (the Mamba states have no slots)."""
        check_cache_write(self.cfg, cache["shared"][0], pos, 1)
