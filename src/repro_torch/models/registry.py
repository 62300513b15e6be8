"""Model registry: ModelConfig -> model instance."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.lm import DecoderLM
from repro_torch.models.xlstm_model import XLSTMLM


def build_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "audio":
        return EncDecLM(cfg)
    if cfg.family == "ssm":
        return XLSTMLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
