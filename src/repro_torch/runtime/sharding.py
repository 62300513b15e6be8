"""Mesh context, logical axes, and placed state.

Counterpart of ``repro.runtime.sharding``.  Models are mesh-agnostic: a
spec names *logical* axes ("batch", "model"), and inside a ``use_mesh``
context they resolve against the physical mesh ("batch" -> every
data-parallel axis present: ("pod", "data") multi-pod, ("data",)
single-pod).  A ``NamedSharding`` pairs a port ``Mesh``
(``repro_torch.dist.mesh``) with a spec, the port's tuple ``P`` of
``plan.lower_dist``: one entry per leading dim, ``None``, an axis name or
a tuple of names.

The reference leaves the split of the work to GSPMD.  The port runs on one
controller (rank threads, or one process per rank) that holds global
tensors, and splits the work where the paper's schedules split it, in the
planned products (``plan.planned_matmuls``).  So ``constrain`` changes
nothing here: it checks that the spec resolves on the active mesh and
returns ``x``.  What the port does place is the training state:
``place`` cuts a tensor into each local rank's block by
``lower_dist.block_slices``, as ``jax.device_put(x, NamedSharding)`` does,
and ``unplace`` gives the full tensor back.

* On one controller the replicas of a block are one tensor: ranks that
  differ only along mesh axes the spec leaves unsharded hold the same
  storage, so a placed state takes no more memory than an unplaced one,
  and an update that walks ``Placed.distinct()`` touches each block once.
* In a process group (``Mesh(..., rank=r)``) a process holds only its own
  rank's block; ``unplace`` all-gathers the blocks over the world.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Mapping
from contextvars import ContextVar
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.plan.lower_dist import P, block_slices, gather
from repro_torch.tree import tree_map

_MESH: ContextVar[Optional[object]] = ContextVar("repro_torch_mesh", default=None)

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def resolve_axis(logical, mesh):
    if logical == "batch":
        axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
        return axes if axes else None
    if logical == "model":
        return MODEL_AXIS if MODEL_AXIS in mesh.axis_names else None
    if logical == "data":
        return "data" if "data" in mesh.axis_names else None
    return logical


def logical_spec(*logical_axes) -> Tuple:
    return logical_axes


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec (the port's ``P``) resolved against ``mesh``."""

    mesh: object
    spec: tuple


def named_sharding(mesh, *logical_axes) -> NamedSharding:
    return NamedSharding(mesh, P(*(resolve_axis(a, mesh) for a in logical_axes)))


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The reference's sharding constraint.  The port's controller holds
    global tensors and splits the work in the planned products, so this
    only checks that the logical axes resolve on the active mesh (an axis
    the mesh lacks raises) and returns ``x`` unchanged."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    for a in logical_axes:
        axes = resolve_axis(a, mesh)
        for name in (() if axes is None else (axes,) if isinstance(axes, str) else axes):
            if name not in mesh.axis_names:
                raise ValueError(f"axis {name!r} is not on mesh {dict(mesh.shape)}")
    return x


def planned_matmul_axes(d_in: int, d_out: int, *, mesh=None,
                        tokens: int = 8192, dtype_bytes: int = 2) -> Tuple:
    """Partition axes for a (d_in, d_out) weight, ranked by ``plan.estimate``.

    Column-parallel ``(None, 'model')`` means the activations must be
    gathered along the contraction (the ring_ag schedule: tokens x d_in
    words move); row-parallel ``('model', None)`` means the partial outputs
    must be reduce-scattered (ring_rs: tokens x d_out words).  Pricing both
    1-D torus solutions with the plan cost model recovers the Megatron
    convention -- column-parallel up-projections, row-parallel
    down-projections -- from the word counts."""
    mesh = mesh if mesh is not None else _MESH.get()
    tp = mesh.shape.get(MODEL_AXIS, 1) if mesh is not None else 1
    if tp <= 1:
        return (None, None)
    from repro_torch.plan import estimate

    col = estimate("ring_ag", tokens, d_out, d_in, tp, dtype_bytes)
    row = estimate("ring_rs", tokens, d_out, d_in, tp, dtype_bytes)
    return (None, MODEL_AXIS) if col.total_s <= row.total_s else (MODEL_AXIS, None)


# -- placed tensors ---------------------------------------------------------------


class Placed(Mapping):
    """A tensor placed on a mesh: ``{rank: block}`` for the local ranks
    (module docstring).  A leaf of the tree helpers (``repro_torch.tree``),
    not a subtree: it is a ``Mapping``, not a ``dict``."""

    def __init__(self, blocks: Dict[int, torch.Tensor], sharding: NamedSharding,
                 shape: Tuple[int, ...], dtype: torch.dtype):
        self.blocks = blocks
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype

    def __getitem__(self, rank: int) -> torch.Tensor:
        return self.blocks[rank]

    def __iter__(self) -> Iterator[int]:
        return iter(self.blocks)

    def __len__(self) -> int:
        return len(self.blocks)

    def __repr__(self) -> str:
        return (f"Placed({tuple(self.shape)}, {self.dtype}, spec={self.sharding.spec}, "
                f"ranks={sorted(self.blocks)})")

    def distinct_ranks(self) -> List[int]:
        """One local rank per distinct block: the first rank holding it."""
        seen, out = set(), []
        for r, blk in self.blocks.items():
            if id(blk) not in seen:
                seen.add(id(blk))
                out.append(r)
        return out

    def distinct(self) -> List[torch.Tensor]:
        """Each distinct local block once (replicas share one tensor)."""
        return [self.blocks[r] for r in self.distinct_ranks()]

    def owned_ranks(self) -> List[int]:
        """The distinct ranks whose block this process counts in a sum
        over the whole mesh: replica 0 of each block (coordinate 0 on
        every mesh axis the spec leaves unsharded), so a sum of the
        processes' local sums counts every block once."""
        mesh, spec = self.sharding.mesh, self.sharding.spec
        used = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        free = [i for i, a in enumerate(mesh.axis_names) if a not in used]
        return [r for r in self.distinct_ranks()
                if not any(mesh.coords(r)[i] for i in free)]


def _slice_key(slices) -> tuple:
    return tuple((s.start, s.stop) for s in slices)


def place(x: torch.Tensor, sharding: NamedSharding) -> Placed:
    """Each local rank's block of ``x`` under ``sharding``, every block a
    contiguous tensor of its own on the mesh's device (never a view of
    ``x``); on one controller, ranks with the same block share one tensor.
    A dim that its axes do not divide raises ``ValueError``."""
    mesh, spec = sharding.mesh, sharding.spec
    blocks, made = {}, {}
    for r in mesh.local_ranks():
        sl = block_slices(x.shape, spec, mesh, r)
        key = _slice_key(sl)
        if key not in made:
            view = x.detach()[sl]
            made[key] = torch.empty(view.shape, dtype=x.dtype,
                                    device=mesh.device).copy_(view)
        blocks[r] = made[key]
    return Placed(blocks, sharding, tuple(x.shape), x.dtype)


def place_into(placed: Placed, x: torch.Tensor) -> Placed:
    """``place`` into ``placed``'s own tensors: each distinct local block of
    ``x`` under ``placed``'s sharding copied into the block ``placed``
    holds, so every block keeps its storage.  ``x`` of another shape
    raises ``ValueError``."""
    if tuple(x.shape) != tuple(placed.shape):
        raise ValueError(f"{tuple(x.shape)} into a placed {tuple(placed.shape)}")
    mesh, spec = placed.sharding.mesh, placed.sharding.spec
    for r in placed.distinct_ranks():
        placed[r].copy_(x.detach()[block_slices(x.shape, spec, mesh, r)])
    return placed


def unplace_tree(tree):
    """``tree`` with every placed leaf unplaced (other leaves as they are)."""
    return tree_map(lambda x: unplace(x) if isinstance(x, Placed) else x, tree)


def unplace(x: Placed) -> torch.Tensor:
    """The full tensor: assembled from the blocks on one controller, all
    gathered over the world in a process group (every process calls it)."""
    mesh, spec = x.sharding.mesh, x.sharding.spec
    if not spec or all(e is None for e in spec):
        # replicated: every rank holds the whole tensor
        return next(iter(x.blocks.values()))
    if len(spec) < len(x.shape):
        spec = spec + (None,) * (len(x.shape) - len(spec))
    return gather(mesh.collect(dict(x.blocks)), spec, mesh)
