"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``cuda``, and asking for ``cuda`` where CUDA is missing
raises instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch
from torch._subclasses.fake_tensor import FakeTensor

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def param_device(params) -> torch.device:
    """The device a model's parameter dict lives on."""
    return params["embed"]["embedding"].device


def maybe_sync(device: Optional[torch.device]) -> None:
    """Wait for queued work on a CUDA device (no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


_bound = threading.local()


def bind_thread(device: torch.device) -> None:
    """Make ``device`` current, with its CUDA context, in the calling
    thread (once per thread and device).  A thread that has made no CUDA
    runtime call yet has no context current, and the driver calls the
    kernels' TMA routes make (``cuTensorMapEncodeTiled``) fail there: a
    fresh rank thread of the plan engine is such a thread.
    ``torch.cuda.set_device`` binds the context."""
    if getattr(_bound, "device", None) != device:
        torch.cuda.set_device(device)
        _bound.device = device



def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (``FakeTensorMode``: a shape, a type
    and a device, no memory)."""
    return isinstance(t, FakeTensor)


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t``'s base is 16-byte aligned.  A fake tensor has no
    address: its base is taken where the card's allocator would put it, a
    fresh buffer (aligned far beyond 16 bytes) plus its storage offset, so
    a fake run picks the route the card would."""
    if is_fake(t):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0


def dispatch_mode_active() -> bool:
    """Whether a ``TorchDispatchMode`` (a fake mode, a counter) is active in
    the calling thread, or in the thread autograd took its state from."""
    return torch._C._len_torch_dispatch_stack() > 0
