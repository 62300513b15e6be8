"""Device-independent scheduling algebra copied from ``repro.core``."""
from .zorder import (enclosing_pow2, morton_decode3, morton_encode3,
                     rowmajor_schedule, zorder_schedule)

__all__ = ["enclosing_pow2", "morton_decode3", "morton_encode3",
           "rowmajor_schedule", "zorder_schedule"]
