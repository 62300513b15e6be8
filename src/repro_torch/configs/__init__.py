"""Architecture configs, one module per architecture: all ten of the reference's.

``get_config(name)`` returns the published configuration and
``get_smoke_config(name)`` a reduced same-family one for CPU tests, as in
``repro.configs``.  The reference's ``DecoderLM`` families:
dense GQA (Llama-3.2-1B; h2o-danube-3-4b with a 4096-token sliding window
and head dim 120; granite-20b, MQA), MLA (minicpm3-4b), MoE (deepseek-moe-16b
with shared experts and a leading dense layer; qwen3-moe-30b-a3b) and the
early-fusion VLM backbone (chameleon-34b); and the reference's other three
families: the Mamba-2 hybrid with one shared attention block (zamba2-2.7b),
xLSTM (xlstm-350m) and the encoder-decoder backbone (seamless-m4t-medium).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ("llama3_2_1b", "granite_20b", "minicpm3_4b", "h2o_danube3_4b", "chameleon_34b",
         "qwen3_moe_30b_a3b", "deepseek_moe_16b", "zamba2_2_7b", "xlstm_350m",
         "seamless_m4t_medium")

ALIASES = {"llama3.2-1b": "llama3_2_1b", "h2o-danube-3-4b": "h2o_danube3_4b"}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def _module(name: str):
    arch = canonical(name)
    if arch not in ARCHS:
        raise ValueError(f"architecture {name!r} is not ported; have {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
