"""repro_torch -- the PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports ``torch`` and
nothing of JAX or of ``repro``, keeping its own copies of what it needs.
Module names mirror the reference so each part can be held against its
counterpart.  Three slices run on one card: serving dense decoder LMs
(Llama-3.2-1B) through the hand-written Z-order matmul kernel
(``repro_torch.kernels.matmul``); the long-context prefill of
h2o-danube-3-4b, whose attention runs the hand-written flash-attention
kernel (``repro_torch.kernels.flash_attention``) when
``attn_impl="flash"``; and training (``repro_torch.runtime.train``), whose
gradients run through the Z-order kernel too.  Entry points default to ``cuda`` and raise when it
is missing unless the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
