from .kernel import BLOCKS, default_blocks, smem_bytes, zorder_matmul
from .ops import matmul
from .ref import matmul_ref

__all__ = ["BLOCKS", "default_blocks", "smem_bytes", "zorder_matmul",
           "matmul", "matmul_ref"]
