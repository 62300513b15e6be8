"""Linear layers routed through the symmetry-scheduled matmul engine.

Counterpart of ``repro.layers.linear``.  Two paths, as in the reference:
outside a plan scope (and on a one-rank mesh) ``linear`` runs
``local_matmul``, with the leading dims folded into rows so every
projection reaches the kernel; inside ``repro_torch.plan.planned_matmuls``
on a mesh of more than one rank, the product dispatches through the plan
engine (cost-model-ranked strategy, cached ``SchedulePlan``, leading dims
folded before planning) and runs as per-rank programs whose block products
are ``local_matmul`` again.  Under autograd the planned product has a
planned backward (``dist.api.symmetric_matmul``): dA and dB are two more
planned products on the same mesh.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.dist.local import local_matmul
from repro_torch.plan.context import planned_mesh, planned_strategy, planned_tuning


def linear_params(generator: torch.Generator, d_in: int, d_out: int,
                  dtype: torch.dtype, device) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * (1.0 / d_in ** 0.5)).to(device=device, dtype=dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 accumulation, in x's dtype."""
    with obs.span("layer.linear"):
        mesh = planned_mesh()
        if mesh is not None and getattr(mesh, "size", 1) > 1:
            from repro_torch.dist.api import symmetric_matmul

            return symmetric_matmul(x, w, mesh=mesh, out_dtype=x.dtype,
                                    strategy=planned_strategy(), tuning=planned_tuning())
        return local_matmul(x, w, out_dtype=x.dtype)
