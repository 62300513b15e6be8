from .kernel import takes, tile_for
from .ops import moe_experts, plain

__all__ = ["moe_experts", "plain", "takes", "tile_for"]
