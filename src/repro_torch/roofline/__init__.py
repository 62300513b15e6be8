"""repro_torch.roofline -- op counts of a running program + roofline terms.

Counterpart of ``repro.roofline``:

  analysis  -- Roofline terms (compute / memory / collective seconds) of a
               counted program at the card's rates
  hlo_stats -- the counter: FLOPs, device-memory bytes and collective bytes
               of every op a program runs (a dispatch mode, on real or fake
               tensors), in place of the reference's HLO text walk
"""
from . import analysis, hlo_stats
from .analysis import Roofline
from .hlo_stats import Cost, analyze, analyze_by_shape

__all__ = ["analysis", "hlo_stats", "Roofline", "Cost", "analyze",
           "analyze_by_shape"]
