"""Production mesh construction (counterpart of ``repro.launch.mesh``).

A function, not a module-level constant, and a ``Mesh`` starts no rank
thread until its first ``run``: importing this module or building the mesh
touches no device.
"""
from __future__ import annotations

from repro_torch.device import DeviceLike
from repro_torch.dist.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> Mesh:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks when ``multi_pod``.
    Axes: (pod,) data, model."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device)
