"""K1's library: ``csrc/*.cu`` (the wmma and fma routes in
``zorder_matmul.cu``, the thin route in ``zorder_matmul_thin.cu``, the wide
route in ``zorder_matmul_wide.cu``) built by the shared builder
(``repro_torch.kernels._build``) into one library in ``build/repro_torch/``
at first use."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P

KERNEL = _build.Kernel(
    csrc=Path(__file__).resolve().parent / "csrc",
    name="zorder_matmul",
    signatures={
        "zorder_matmul_launch": ([P, P, P, P, I, I, I, I, I, I, I, I, I, P], I),
        "zorder_matmul_thin_launch": ([P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P],
                                      I),
        "zorder_matmul_wide_launch": ([P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P], I),
        "zorder_matmul_error_string": ([I], ctypes.c_char_p),
    },
)


def build() -> Path:
    return _build.build(KERNEL)


def load() -> ctypes.CDLL:
    return _build.load(KERNEL)
