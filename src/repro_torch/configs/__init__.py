"""Architecture configs, one module per architecture: all ten of the
reference's, and the port's own DeepSeek-V2-Lite (``PORT_ARCHS``).

``get_config(name)`` returns the published configuration and
``get_smoke_config(name)`` a reduced same-family one for CPU tests, as in
``repro.configs``.  The reference's ``DecoderLM`` families:
dense GQA (Llama-3.2-1B; h2o-danube-3-4b with a 4096-token sliding window
and head dim 120; granite-20b, MQA), MLA (minicpm3-4b), MoE (deepseek-moe-16b
with shared experts and a leading dense layer; qwen3-moe-30b-a3b) and the
early-fusion VLM backbone (chameleon-34b); and the reference's other three
families: the Mamba-2 hybrid with one shared attention block (zamba2-2.7b),
xLSTM (xlstm-350m) and the encoder-decoder backbone (seamless-m4t-medium).
``SHAPES`` are the reference's input-shape cells and ``runnable_cells()``
its (arch x shape) grid minus the documented skips, which the dry run
(``launch.dryrun``) walks.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

# in the reference's order, which ``runnable_cells`` walks
ARCHS = ("llama3_2_1b", "granite_20b", "minicpm3_4b", "h2o_danube3_4b", "chameleon_34b",
         "qwen3_moe_30b_a3b", "deepseek_moe_16b", "seamless_m4t_medium", "xlstm_350m",
         "zamba2_2_7b")

# the port's own, beyond the reference's: not in ``ARCHS``, so not in its
# (arch x shape) grid; ``get_config`` finds them all the same
PORT_ARCHS = ("deepseek_v2_lite",)   # DeepSeek-V2-Lite (hf:deepseek-ai/DeepSeek-V2-Lite)

ALIASES = {"llama3.2-1b": "llama3_2_1b", "h2o-danube-3-4b": "h2o_danube3_4b"}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic decode)
LONG_CONTEXT_OK = {"xlstm_350m", "zamba2_2_7b", "h2o_danube3_4b"}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def _module(name: str):
    arch = canonical(name)
    if arch not in ARCHS + PORT_ARCHS:
        raise ValueError(f"architecture {name!r} is not ported; have {ARCHS + PORT_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def runnable_cells() -> List[Tuple[str, str]]:
    cells = []
    for arch in ARCHS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
                continue
            cells.append((arch, shape))
    return cells


def skipped_cells() -> List[Tuple[str, str, str]]:
    return [
        (arch, "long_500k", "full-attention arch: 500k dense-KV decode is not sub-quadratic")
        for arch in ARCHS if arch not in LONG_CONTEXT_OK
    ]
