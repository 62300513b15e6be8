"""Elastic re-meshing: rebuild a smaller mesh after a pod is lost and
re-place the training state onto it.

Counterpart of ``repro.runtime.elastic``.  The recovery unit is a pod: drop
the failed pod from the ``pod`` axis (several pods -> fewer, two -> a
single-pod mesh without the axis), re-place the state from the latest
checkpoint, continue.  The port's meshes are ``dist.mesh.Mesh``es of rank
threads on one device; a survivor mesh numbers its ranks afresh.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

from repro_torch.device import DeviceLike
from repro_torch.dist.mesh import Mesh
from repro_torch.models.sharding_rules import param_shardings
from repro_torch.runtime.sharding import NamedSharding, place, unplace_tree
from repro_torch.tree import tree_map


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: DeviceLike = None) -> Mesh:
    return Mesh(tuple(shape), tuple(axes), device=device)


def shrink_after_failure(mesh: Mesh, lost_pod: int = 0) -> Mesh:
    """The survivor mesh after losing pod ``lost_pod``."""
    names = mesh.axis_names
    if "pod" in names and mesh.shape["pod"] > 1:
        if not 0 <= lost_pod < mesh.shape["pod"]:
            raise ValueError(f"no pod {lost_pod} on a mesh of {mesh.shape['pod']} pods")
        sizes = dict(mesh.shape, pod=mesh.shape["pod"] - 1)
        if sizes["pod"] == 1:
            names = tuple(n for n in names if n != "pod")
        return Mesh(tuple(sizes[n] for n in names), names, device=mesh.device)
    raise ValueError("no pod axis to shrink; replace failed hosts instead")


def replace_state(state: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Re-place an AdamW state onto ``mesh``: ``step`` replicated, master,
    m and v by ``param_shardings``.  Each leaf is unplaced first if it is
    placed (on its old mesh), so a state moves between meshes, or from
    the full arrays of a checkpoint onto a mesh."""
    full = unplace_tree(state)
    psh = param_shardings(full["master"], mesh)
    out = {"step": place(full["step"], NamedSharding(mesh, ()))}
    for key in ("master", "m", "v"):
        out[key] = tree_map(place, full[key], psh)
    return out
