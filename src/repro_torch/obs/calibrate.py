"""Calibration pass: microbenchmark the machine's links, fit α–β, and
return a versioned :class:`~repro_torch.obs.profile.MachineProfile`.

Port of ``repro.obs.calibrate``.  ``probe_links(mesh)`` is the library
entry point (``repro_torch.launch.perf_probe`` adds the ``__main__`` that
writes the profile JSON the planner consumes):

  * per mesh axis of size >= 2, a ring ``ppermute`` (+1 hop, every rank
    sending one shard) of increasing shard sizes is timed, best of
    ``reps`` after one warm call, and α–β fitted per axis; a pooled fit
    over every axis becomes the ``"ici"`` link class the planner reads by
    default, and ``tree_axes`` pool into ``"dcn"`` instead;
  * a device-local copy of the same sizes is fitted as the ``"local"``
    class (and stands in as ``"ici"`` without a mesh, or on one rank);
  * peak FLOP/s come from the Z-order matmul (K1) at a large bf16 square
    product: the wide route on the card, not ``torch.matmul``.

On the card, time is CUDA events on the caller's stream (every rank
stream of a single-controller mesh forks from it and joins back to it in
each ``Mesh.run``), so a collective's time includes the host's barrier
exchange between the rank threads; on the CPU it is the host clock.  On one card every "link" is a device copy
between rank threads, and the profile says so (``link_medium``); its
``platform`` and ``device_kind`` are the device's.  Nothing touches the
device at import.
"""
from __future__ import annotations

import datetime
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from .profile import LinkParams, MachineProfile, fit_alpha_beta
from .runtime import span

# Shard sizes per device type: on the card a rank-thread ppermute costs
# hundreds of µs on the host whatever its size, so only shards of 100 MB and
# more show the copy bandwidth under it
DEFAULT_SIZES_BYTES: Dict[str, Tuple[int, ...]] = {
    "cuda": (1 << 20, 1 << 24, 1 << 27, 1 << 29, 1 << 30),
    "cpu": (1 << 14, 1 << 17, 1 << 20)}
# K1's peak-FLOP/s probe: an n x n x n bf16 product (the wide route on the
# card); the plain version on the CPU gets a small one
PEAK_N = {"cuda": 8192, "cpu": 256}


def _time_best(fn, reps: int, device: torch.device) -> float:
    """Best-of-``reps`` seconds of ``fn()`` after one warm call: CUDA events
    on the current stream on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(max(reps, 1)):
        if device.type == "cuda":
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def _probe_axis(mesh, axis: str, size_bytes: int, reps: int) -> float:
    """Seconds for one ring-neighbour ppermute of a ``size_bytes`` fp32
    shard along ``axis``, every rank sending (one ``Mesh.run``)."""
    from repro_torch.dist import _collectives

    ax_size = int(mesh.shape[axis])
    words = max(size_bytes // 4, 1)
    perm = [(i, (i + 1) % ax_size) for i in range(ax_size)]
    shards = {r: (torch.zeros(words, dtype=torch.float32, device=mesh.device),)
              for r in mesh.local_ranks()}

    def body(x):
        return _collectives.ppermute(x, axis, perm)

    return _time_best(lambda: mesh.run(body, shards), reps, mesh.device)


def _probe_local(device: torch.device, size_bytes: int, reps: int) -> float:
    """Seconds of one device-local copy of ``size_bytes``."""
    src = torch.zeros(max(size_bytes // 4, 1), dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    return _time_best(lambda: dst.copy_(src), reps, device)


def _probe_peak_flops(device: torch.device, reps: int) -> float:
    """Measured peak FLOP/s of K1 at an n x n x n bf16 product (``PEAK_N``)."""
    from repro_torch.kernels.matmul.ops import matmul

    n = PEAK_N[device.type]
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)
    t = _time_best(lambda: matmul(a, b), reps, device)
    return 2.0 * n ** 3 / max(t, 1e-12)


def _assemble_links(axis_samples, tree_axes: Sequence[str] = ()):
    """Compose the profile's link-class table from per-axis probe samples.

    ``axis_samples`` is ``[(axis, sizes_bytes, times_s), ...]``.  Every
    measured axis keeps its own ``axis:{name}`` class; non-tree axes pool
    into ``"ici"`` (the planner's default link class) and ``tree_axes``
    into ``"dcn"``; when every measured axis is a tree axis, ``"ici"``
    falls back to the dcn fit (the reference's rule)."""
    tree_axes = frozenset(tree_axes)
    links = []
    ici: Tuple[list, list] = ([], [])
    dcn: Tuple[list, list] = ([], [])
    for axis, sizes, times in axis_samples:
        links.append((f"axis:{axis}", fit_alpha_beta(sizes, times)))
        sink = dcn if axis in tree_axes else ici
        sink[0].extend(sizes)
        sink[1].extend(times)
    pooled = []
    if ici[0]:
        pooled.append(("ici", fit_alpha_beta(*ici)))
    elif dcn[0]:
        pooled.append(("ici", fit_alpha_beta(*dcn)))
    if dcn[0]:
        pooled.append(("dcn", fit_alpha_beta(*dcn)))
    return pooled + links


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def probe_links(mesh=None, *, device=None,
                sizes_bytes: Optional[Sequence[int]] = None,
                reps: int = 3,
                tree_axes: Sequence[str] = ()) -> MachineProfile:
    """Microbenchmark every link class of ``mesh`` (a ``repro_torch.dist.Mesh``)
    and return the fitted :class:`MachineProfile` (see module docstring).
    ``device`` is the mesh's when a mesh is given, else the default
    device (``cuda``); ``sizes_bytes`` default to ``DEFAULT_SIZES_BYTES``
    of its type.  Persist the result with ``save_profile`` and hand it to
    ``build_plan(profile=...)``."""
    from repro_torch.device import resolve_device

    device = mesh.device if mesh is not None else resolve_device(device)
    kind = _device_kind(device)
    with span("obs.calibrate", mesh=str(getattr(mesh, "shape", None))):
        sizes = list(sizes_bytes or DEFAULT_SIZES_BYTES[device.type])
        local = fit_alpha_beta(sizes, [_probe_local(device, s, reps) for s in sizes])
        links = []
        medium = f"device-local copies on {kind}"
        if mesh is not None and mesh.size > 1:
            samples = []
            for axis in mesh.axis_names:
                if int(mesh.shape[axis]) < 2:
                    continue
                samples.append((axis, sizes, [_probe_axis(mesh, axis, s, reps) for s in sizes]))
            links = _assemble_links(samples, tree_axes)
            medium = (f"device copies between the rank threads of one process on {kind}"
                      if mesh.rank is None else
                      f"torch.distributed collectives between processes on {kind}")
        if not links:
            links = [("ici", local)]
        return MachineProfile(
            platform=device.type,
            peak_flops=_probe_peak_flops(device, reps),
            links=tuple(links) + (("local", local),),
            created=datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
            device_kind=kind,
            link_medium=medium,
        )
