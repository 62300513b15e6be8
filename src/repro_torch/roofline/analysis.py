"""Roofline terms from a counted program, priced at the card's rates.

Counterpart of ``repro.roofline.analysis``:

    compute term    = FLOPs / peak FLOP/s              (per chip)
    memory term     = bytes / memory bandwidth         (per chip)
    collective term = collective bytes / link bandwidth (per chip, per link)

The counts come from ``roofline.hlo_stats`` (``Cost``), so
``from_compiled`` becomes ``from_cost(cost, chips, model_flops)``.  The
reference prices at a TPU v5e's constants; here the rates are carried on
the ``Roofline`` and default to the card's, from the NVIDIA H100 SXM5 data
sheet at 700 W: 989e12 dense bf16 FLOP/s on the tensor cores, 3.35e12 B/s
of HBM3, and NVLink 4's 450e9 B/s a direction for the collective term.
This module is the one home of those numbers (``PEAK_FLOPS``,
``HBM_BW``); the kernels' bounds and metrics read them here.  A (16, 16)
mesh of H100s spans 32 nodes of 8 cards, and its collectives between nodes
cross InfiniBand at a fraction of NVLink's rate: there the collective term
is a lower bound.  Every FLOP is priced at the bf16 tensor-core peak (fp32
work runs at 67e12 outside the tensor cores), so the compute term is a
lower bound as well.

The reference also keeps ``xla_flops``, XLA's own ``cost_analysis`` of the
compiled program (which counts a scanned body once); the port compiles no
program and has no such second count, so the field is left out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .hlo_stats import COLLECTIVES, Cost

# NVIDIA H100 SXM5 80GB, data sheet, 700 W.
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor cores, FLOP/s
PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float32: 67e12}   # fp32: no tensor cores
HBM_BW = 3.35e12              # HBM3, B/s
LINK_BW = 450e9               # NVLink 4, B/s a direction
HBM_BYTES = 80 * 2 ** 30      # the card's memory, as the dry run's fit test reads it


def collective_bytes(cost: Cost) -> Dict[str, int]:
    """Bytes moved by each collective kind (output-shape accounting, the
    reference's convention) in a counted program."""
    return {k: int(cost.coll.get(k, 0)) for k in COLLECTIVES}


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective bytes (sum kinds)
    coll_by_kind: Dict[str, int]
    model_flops: Optional[float] = None   # 6ND-style useful flops (global)
    chips: int = 1
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap bound: the dominant term is the step time."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        if not self.model_flops:
            return None
        return self.model_flops / self.chips / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> Optional[float]:
        """MODEL_FLOPS-based MFU bound implied by the three terms."""
        if not self.model_flops:
            return None
        ideal = self.model_flops / self.chips / self.peak_flops
        return ideal / max(self.step_s, 1e-30)

    def summary(self) -> Dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s_bound": self.step_s,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def from_cost(cost: Cost, chips: int, model_flops: Optional[float] = None,
              **rates) -> Roofline:
    """Roofline terms of one chip's counted program (``rates``: other
    ``peak_flops``, ``hbm_bw`` or ``link_bw`` than the card's)."""
    return Roofline(
        flops=float(cost.flops),
        hbm_bytes=float(cost.bytes),
        coll_bytes=float(cost.coll_bytes),
        coll_by_kind=collective_bytes(cost),
        model_flops=model_flops,
        chips=chips,
        **rates,
    )


def train_model_flops(n_active_params: float, tokens: float) -> float:
    return 6.0 * n_active_params * tokens


def infer_model_flops(n_active_params: float, tokens: float) -> float:
    return 2.0 * n_active_params * tokens
