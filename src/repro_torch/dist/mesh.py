"""The mesh the plan engine runs on: named axes over R ranks.

Counterpart of the ``jax.sharding.Mesh`` the reference plans against.  A
``Mesh`` maps axis names to sizes and numbers its ranks row-major over the
axis names (the first name major), as ``jax.lax.ppermute`` numbers devices
over an axis tuple (``repro.core.schedule``'s flat ``x * q + y``).  The
planner reads only ``axis_names``, ``shape``, ``size`` and ``devices``;
``repro_torch.plan.lower_dist`` runs a planned product as one per-rank
program per rank, through ``run``.

Two ways to run the ranks:

* **single controller** (``rank=None``, the default): the R ranks run as R
  Python threads of this process, every rank's tensors on ``device`` (the
  card unless the caller asks for the CPU), and a collective is a barrier
  exchange between the threads (``dist._collectives.ThreadCommunicator``).
  This is how one card runs a 2x2 or 2x2x2 mesh; it needs no process group.
* **process group** (``rank=r``): this process is rank ``r`` of a
  ``torch.distributed`` world of ``size`` processes (initialised by the
  caller), and the collectives are the process group's
  (``dist._collectives.ProcessGroupCommunicator``): gloo on CPU ranks, NCCL
  on one card per rank.

A mesh is hashable and weak-referenceable by identity, as the plan cache
and ``plan.ir.mesh_fingerprint`` need.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Axes = Tuple[str, ...]

# Axis names a mesh gets from its sizes alone, as the reference's launchers
# name theirs: a ring, a torus (``--mesh RxC``), a pod of tori.
DEFAULT_AXIS_NAMES = {1: ("t",), 2: ("x", "y"), 3: ("pod", "x", "y")}
# Seconds a rank waits at a collective for the others before the run fails
# (a backstop: a failed or finished rank releases the others at once).
COLLECTIVE_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """One entry of ``Mesh.devices``: the rank's id and where it runs
    (``platform`` names the device and how ranks talk, so two meshes that
    run differently never share a fingerprint)."""

    id: int
    platform: str


def as_axes(axes) -> Axes:
    """An axis name or a tuple of names, as a tuple."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Named axes over ``prod(sizes)`` ranks (see the module docstring)."""

    def __init__(self, sizes: Sequence[int], axis_names: Optional[Sequence[str]] = None,
                 *, device: DeviceLike = None, rank: Optional[int] = None):
        sizes = tuple(int(s) for s in sizes)
        if axis_names is None:
            if len(sizes) not in DEFAULT_AXIS_NAMES:
                raise ValueError(f"name the axes of a {len(sizes)}-axis mesh")
            axis_names = DEFAULT_AXIS_NAMES[len(sizes)]
        names = tuple(axis_names)
        if len(names) != len(sizes) or not sizes:
            raise ValueError(f"mesh sizes {sizes} and axis names {names} differ in length")
        if len(set(names)) != len(names) or any(s < 1 for s in sizes):
            raise ValueError(f"mesh needs distinct axis names and positive sizes, got "
                             f"{dict(zip(names, sizes))}")
        self.axis_names: Axes = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.size = math.prod(sizes)
        self.device = resolve_device(device)
        if rank is not None and not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size} ranks")
        self.rank = rank
        how = "threads" if rank is None else "process-group"
        self.devices = np.empty(sizes, dtype=object)
        for r in range(self.size):
            self.devices[self.coords(r)] = RankDevice(r, f"{how}:{self.device}")
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._comm = None
        self._lock = threading.Lock()
        self._memo: Dict[tuple, object] = {}   # (what, rank, axes) -> answer

    def __repr__(self) -> str:
        how = "threads" if self.rank is None else f"rank {self.rank}"
        return f"Mesh({self.shape}, device={self.device}, {how})"

    # -- rank numbering ------------------------------------------------------

    def coords(self, rank: int) -> Tuple[int, ...]:
        """The rank's index along each axis (row-major, first axis major)."""
        return tuple(int(c) for c in np.unravel_index(rank, tuple(self.shape.values())))

    def rank_of(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), tuple(self.shape.values())))

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in as_axes(axes))

    def axis_index(self, rank: int, axes) -> int:
        """The rank's position in its group over ``axes``: row-major over
        the named axes in the order given, the first name major (the flat
        index ``jax.lax.axis_index`` gives over an axis tuple)."""
        key = ("index", rank, as_axes(axes))
        if key not in self._memo:
            c = dict(zip(self.axis_names, self.coords(rank)))
            idx = 0
            for a in key[2]:
                idx = idx * self.shape[a] + c[a]
            self._memo[key] = idx
        return self._memo[key]

    def group(self, rank: int, axes) -> Tuple[int, ...]:
        """The ranks that share ``rank``'s coordinates off ``axes``, in
        group order (``axis_index`` over ``axes``)."""
        key = ("group", rank, as_axes(axes))
        if key not in self._memo:
            self._memo[key] = self._group(rank, key[2])
        return self._memo[key]

    def _group(self, rank: int, axes: Axes) -> Tuple[int, ...]:
        base = dict(zip(self.axis_names, self.coords(rank)))
        out = []
        for idx in range(self.axis_size(axes)):
            c = dict(base)
            for a, v in zip(axes, np.unravel_index(idx, [self.shape[a] for a in axes])):
                c[a] = int(v)
            out.append(self.rank_of([c[a] for a in self.axis_names]))
        return tuple(out)

    def groups(self, axes) -> Tuple[Tuple[int, ...], ...]:
        """Every group over ``axes`` (the partition of the ranks), each in
        group order, ordered by their first member."""
        seen, out = set(), []
        for r in range(self.size):
            if r not in seen:
                g = self.group(r, axes)
                seen.update(g)
                out.append(g)
        return tuple(out)

    # -- running the per-rank programs ----------------------------------------

    def local_ranks(self) -> Tuple[int, ...]:
        """The ranks this process runs: all of them on a single controller,
        its own in a process group."""
        return tuple(range(self.size)) if self.rank is None else (self.rank,)

    def run(self, fn: Callable, args: Dict[int, tuple]) -> Dict[int, object]:
        """``fn(*args[r])`` on every local rank ``r``, each with its rank's
        communicator current (``dist._collectives``) and, under obs
        tracing, the caller's span tags; returns ``{r: out}``.
        On a single controller the ranks run at once, one thread each; if
        one raises, the others are released from their collectives and the
        first error is raised here."""
        from repro_torch import obs

        from . import _collectives

        if self.rank is not None:
            if self._comm is None:
                self._comm = _collectives.ProcessGroupCommunicator(self)
            with _collectives.current(self._comm):
                return {self.rank: fn(*args[self.rank])}
        with self._lock:   # one mesh runs one product at a time
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.size, thread_name_prefix="mesh-rank")
            rendezvous = _collectives.Rendezvous(self.size, COLLECTIVE_TIMEOUT_S)
            stream = (torch.cuda.current_stream(self.device)
                      if self.device.type == "cuda" else None)
            tags = obs.current_tags() if obs.enabled() else None
            futures = {
                r: self._pool.submit(_collectives.run_rank,
                                     _collectives.ThreadCommunicator(self, r, rendezvous),
                                     stream, fn, args[r], tags)
                for r in range(self.size)}
            outs, errors = {}, []
            for r, fut in futures.items():
                try:
                    outs[r] = fut.result()
                except BaseException as e:  # noqa: B902 -- re-raised below
                    errors.append(e)
        if errors:
            first = next((e for e in errors if not isinstance(e, _collectives.RankAborted)),
                         errors[0])
            raise first
        return outs

    def collect(self, outs: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """Every rank's output: already all here on a single controller; in
        a process group, gathered from the world (all blocks of one output
        spec have one shape)."""
        if self.rank is None:
            return outs
        import torch.distributed as dist

        mine = outs[self.rank].contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine)
        return dict(enumerate(parts))

    def close(self) -> None:
        """Stop the rank threads (a later ``run`` starts them again)."""
        with self._lock:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None


def parse_mesh(spec: str, *, device: DeviceLike = None) -> Mesh:
    """A mesh from ``"RxC"`` (``"4"``, ``"2x2"``, ``"2x2x2"``), its axes
    named as ``DEFAULT_AXIS_NAMES``."""
    try:
        sizes = tuple(int(s) for s in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh spec {spec!r} is not of the form RxC") from None
    return Mesh(sizes, device=device)
