"""Matmul execution; on one device the schedule resolves to ``local_matmul``."""
from .local import local_matmul

__all__ = ["local_matmul"]
