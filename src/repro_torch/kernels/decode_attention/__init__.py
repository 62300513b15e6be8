from .kernel import split_plan, takes
from .ops import decode_attention, plain

__all__ = ["decode_attention", "plain", "split_plan", "takes"]
