"""Architecture configs ported so far, one module per architecture.

``get_config(name)`` returns the published configuration and
``get_smoke_config(name)`` a reduced same-family one for CPU tests, as in
``repro.configs``.  Ported so far: Llama-3.2-1B and h2o-danube-3-4b (dense
GQA; danube adds a 4096-token sliding window and head dim 120).  The other
reference architectures wait for their layer families.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ("llama3_2_1b", "h2o_danube3_4b")

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
