"""xLSTM LM: repeating groups of mLSTM and sLSTM blocks.

Counterpart of ``repro.models.xlstm_model``.  The group pattern comes from
``cfg.block_pattern`` (default mmm-s); within a group every mLSTM block
runs first, then every sLSTM block, as the reference's scans do.  The
reference stacks each kind's parameters on a leading axis; here
``params["m_layers"]`` and ``params["s_layers"]`` are flat lists in the
same order (group g's mLSTM blocks are ``m_layers[g * n_m:(g + 1) * n_m]``),
and the caches ``cache["m"]`` / ``cache["s"]`` are lists of per-block
states written in place.  There is no ``prefill`` and no per-row position
offsets, as in the reference (``models/hybrid.py``'s docstring): the
state has no slots, so only ``ServeConfig.validate_prompt_len`` bounds a
request.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layers.blocks import block_apply, block_params
from repro_torch.layers.embed import embed, embed_params, unembed
from repro_torch.layers.norms import rms_norm, rms_norm_params
from repro_torch.layers.xlstm import mlstm_cache, slstm_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import cross_entropy, decode_positions, remat

Params = Dict
Cache = Dict


class XLSTMLM:
    def __init__(self, cfg: ModelConfig):
        pattern = cfg.block_pattern or ("mlstm", "mlstm", "mlstm", "slstm")
        if cfg.num_layers % len(pattern):
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole groups of "
                             f"{pattern}")
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.pattern = pattern
        self.n_groups = cfg.num_layers // len(pattern)
        self.n_m = sum(1 for b in pattern if b == "mlstm")
        self.n_s = sum(1 for b in pattern if b == "slstm")

    def _kinds(self) -> List[Tuple[str, str, str, int]]:
        """(params key, cache key, block kind, blocks a group) in the order a
        group runs them."""
        return [(pk, ck, kind, n) for pk, ck, kind, n in (
            ("m_layers", "m", "mlstm", self.n_m), ("s_layers", "s", "slstm", self.n_s)) if n]

    def init(self, generator: torch.Generator, device: DeviceLike = None) -> Params:
        device = resolve_device(device)
        cfg = self.cfg
        params: Params = {
            "embed": embed_params(generator, cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                                  self.dtype, device),
            "final_norm": rms_norm_params(cfg.d_model, device),
        }
        for pk, _, kind, n in self._kinds():
            params[pk] = [block_params(generator, cfg, kind, self.dtype, device)
                          for _ in range(self.n_groups * n)]
        return params

    def param_stacks(self) -> List[Tuple[str, int]]:
        return [(pk, self.n_groups * n) for pk, _, _, n in self._kinds()]

    def _run(self, params: Params, x: torch.Tensor, positions, cache=None, pos=None):
        """Every group's blocks in order; with ``cache`` each block's state
        in place."""
        block = remat(self._block, self.cfg) if cache is None else self._block
        for g in range(self.n_groups):
            for pk, ck, kind, n in self._kinds():
                for i in range(g * n, (g + 1) * n):
                    lc = None if cache is None else cache[ck][i]
                    x = block(params[pk][i], x, positions, kind, lc, pos)
        return x

    def _block(self, lp, x, positions, kind, cache=None, pos=None):
        return block_apply(lp, x, self.cfg, kind, positions, cache, pos)[0]

    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (logits (B, S, V_padded) fp32, aux 0)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        x = self._run(params, x, torch.arange(tokens.shape[1], device=tokens.device))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return unembed(params["embed"], x, cfg.vocab_size), aux

    def loss(self, params: Params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        logits, _ = self.forward(params, batch["tokens"])
        ce = cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce}

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device) -> Cache:
        """One state per block (``max_seq`` is unused: no slots)."""
        cfg = self.cfg
        make = {"mlstm": lambda: mlstm_cache(cfg, batch, device),
                "slstm": lambda: slstm_cache(cfg, batch, device)}
        return {ck: [make[kind]() for _ in range(self.n_groups * n)]
                for _, ck, kind, n in self._kinds()}

    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B, 1) -> (logits (B, V_padded), cache), every state
        written in place.  ``pos`` (an int or a 0-d tensor) is unused by the
        blocks, as in the reference."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        x = self._run(params, x, decode_positions(pos, tokens.device), cache, pos)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(params["embed"], x, cfg.vocab_size)[:, 0], cache

    def check_decode_pos(self, cache: Cache, pos: int) -> None:
        """Nothing to check: the recurrent state has no slots."""
