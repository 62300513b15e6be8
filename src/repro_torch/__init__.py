"""repro_torch -- the PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports ``torch`` and
nothing of JAX or of ``repro``, keeping its own copies of what it needs.
Module names mirror the reference so each part can be held against its
counterpart.  The first slice serves dense decoder LMs (Llama-3.2-1B) on
one card through the hand-written Z-order matmul kernel
(``repro_torch.kernels.matmul``); entry points default to ``cuda`` and
raise when it is missing unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
