"""Performance probes: link calibration and K1 autotuning on the card.

Port of ``repro.launch.perf_probe``'s calibration mode.  **Library entry
point** -- ``probe_links(mesh) -> MachineProfile`` runs the
``repro_torch.obs.calibrate`` microbenchmarks (ring ppermutes per mesh
axis, a local copy, K1's peak) and returns the fitted α–β machine profile
``build_plan(profile=...)`` ranks with.  Importing this module touches no
device.

**CLI** -- the default mode calibrates and writes the machine-profile JSON:

    PYTHONPATH=src python -m repro_torch.launch.perf_probe \\
        --profile-out machine_profile.json --mesh-shape 2x2

The mesh's ranks are threads of this process on the one device
(``--device``, default ``cuda``), so on one card its links are device
copies between them; the profile says so (``link_medium``).  ``--tune``
additionally runs the measured K1 autotune search (``repro_torch.tune``)
over ``--tune-shapes`` and embeds the resulting ``TuningTable`` in the
profile (and, with ``--tune-out``, writes it as its own artifact), keyed by
the card's name.  ``--tune-dtype`` defaults to bfloat16, the serving
dtype (the reference's default, float32, runs K1's fma route only).

The reference's legacy perf-iteration mode (``--arch``: lower one arch x
shape cell and print its roofline terms) needs the dry-run launcher and
the roofline tooling, which the port does not have yet (``ROADMAP.md``,
queue 1, item 9); it raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.obs.calibrate import probe_links
from repro_torch.obs.profile import MachineProfile, save_profile  # noqa: F401

__all__ = ["probe_links", "main"]


def _parse_shape(spec: str):
    return tuple(int(s) for s in spec.lower().split("x") if s)


def calibrate_main(args) -> MachineProfile:
    """Default mode: probe the links, optionally tune, write the profile."""
    from repro_torch.device import resolve_device
    from repro_torch.dist.mesh import Mesh

    device = resolve_device(args.device)
    mesh = None
    if args.mesh_shape:
        shape = _parse_shape(args.mesh_shape)
        names = ("x", "y", "z")[:len(shape)] if len(shape) > 1 else ("t",)
        mesh = Mesh(shape, names, device=device)
    tree_axes = tuple(a for a in args.tree_axes.split(",") if a)
    try:
        profile = probe_links(mesh, device=device, reps=args.reps, tree_axes=tree_axes)
    finally:
        if mesh is not None:
            mesh.close()
    if args.tune:
        from repro_torch.tune import Tuner, save_table

        tuner = Tuner(reps=args.tune_reps, max_candidates=args.tune_candidates or None,
                      device=device)
        for spec in args.tune_shapes.split(","):
            if spec:
                tm, tn, tk = _parse_shape(spec)
                tuner.entry_for(tm, tn, tk, dtype=args.tune_dtype)
        table = tuner.table()
        profile = dataclasses.replace(profile, tuning=table)
        if args.tune_out:
            save_table(table, args.tune_out)
            print(f"# wrote {args.tune_out}")
    save_profile(profile, args.profile_out)
    print(json.dumps(profile.to_json(), indent=1, sort_keys=True))
    print(f"# wrote {args.profile_out}")
    return profile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    # calibration mode (default)
    ap.add_argument("--profile-out", default="machine_profile.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 2x2 or 4 -- the rank-thread mesh to probe axes on")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tree-axes", default="",
                    help="comma-separated inter-pod (DCN-class) mesh axes; "
                         "pooled into a 'dcn' link class instead of 'ici'")
    ap.add_argument("--tune", action="store_true",
                    help="also run the K1 autotune search and embed the "
                         "TuningTable in the profile")
    ap.add_argument("--tune-shapes", default="256x256x256,384x128x256",
                    help="comma-separated MxNxK shapes to tune")
    ap.add_argument("--tune-reps", type=int, default=3)
    ap.add_argument("--tune-candidates", type=int, default=8,
                    help="bound the per-shape candidate search (0 = full)")
    ap.add_argument("--tune-dtype", default="bfloat16")
    ap.add_argument("--tune-out", default="",
                    help="also write the TuningTable as its own JSON")
    # the reference's legacy cell-probe mode (selected by --arch)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    args = ap.parse_args(argv)

    if args.arch is not None:
        raise NotImplementedError(
            "the --arch cell probe lowers a dry-run cell and reads its roofline terms; "
            "the port's dry-run launcher and roofline tooling are still to come "
            "(ROADMAP.md, queue 1, item 9)")
    calibrate_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
