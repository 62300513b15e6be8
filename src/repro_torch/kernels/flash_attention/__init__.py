from .kernel import flash_attention, flash_attention_bshd
from .ops import mha
from .ref import attention_ref

__all__ = ["flash_attention", "flash_attention_bshd", "mha", "attention_ref"]
