"""Linear layers over the local Z-order matmul.

On one device the reference's ``linear`` runs ``local_matmul`` (its plan
engine is entered only on a multi-device mesh); so does this one, and with
the leading dims folded into rows every projection reaches the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.dist.local import local_matmul


def linear_params(generator: torch.Generator, d_in: int, d_out: int,
                  dtype: torch.dtype, device) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * (1.0 / d_in ** 0.5)).to(device=device, dtype=dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 accumulation, in x's dtype."""
    return local_matmul(x, w, out_dtype=x.dtype)
