"""Model registry: ModelConfig -> model instance."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import DecoderLM


def build_model(cfg: ModelConfig) -> DecoderLM:
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    raise NotImplementedError(f"model family {cfg.family!r} is not ported yet")
