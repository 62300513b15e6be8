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

The reference's legacy perf-iteration mode is selected by ``--arch``: count
ONE arch x shape cell with config overrides on a production mesh through
the dry run (``launch.dryrun.lower_cell``, fake tensors) and print its
roofline terms:

    PYTHONPATH=src python -m repro_torch.launch.perf_probe \
        --arch granite-20b --shape train_4k \
        --set remat=none attn_probs_dtype=bf16 --no-zero --tag it3

Overrides apply ``dataclasses.replace`` on the arch config.  The port has
one analyzer, the reference's naive count (``roofline.hlo_stats``: the
VMEM-residency rule is a TPU's), so every record says
``"analyzer": "naive"``; ``--naive-analyzer`` is accepted for the
reference's command lines.  Appends a JSON record to ``--out``
(``perf_iterations.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

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


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def cell_probe_main(args) -> dict:
    """The ``--arch`` mode: one cell's roofline terms (module docstring)."""
    from repro_torch.configs import canonical, get_config
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_production_mesh

    overrides = dict(parse_override(kv) for kv in args.set)
    arch = canonical(args.arch)
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"), device=args.device)
    t0 = time.perf_counter()
    rec = lower_cell(arch, args.shape, mesh, remat=args.remat, zero=not args.no_zero,
                     device=args.device, cfg=cfg)
    rec.update(tag=args.tag, overrides=overrides, zero=not args.no_zero,
               remat=args.remat, analyzer="naive",
               wall_s=round(time.perf_counter() - t0, 1))
    r = rec["roofline"]
    print(json.dumps({
        "tag": args.tag, "arch": rec["arch"], "shape": rec["shape"],
        "dominant": r["dominant"],
        "compute_s": r["compute_s"], "memory_s": r["memory_s"],
        "collective_s": r["collective_s"], "step_bound_s": r["step_s_bound"],
        "roofline_fraction": r["roofline_fraction"],
        "coll_by_kind": r["coll_by_kind"],
        "peak_GiB": round((rec["memory"]["peak_bytes"] or 0) / 2**30, 2),
    }, indent=1))
    hist = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            hist = json.load(f)
    hist.append(rec)
    with open(args.out, "w") as f:
        json.dump(hist, f, indent=1)
    return rec


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
    # the reference's legacy cell-probe mode (selected by --arch); --device
    # is the fake tensors' device there
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--set", nargs="*", default=[], metavar="key=val")
    ap.add_argument("--remat", default="config")
    ap.add_argument("--no-zero", action="store_true")
    ap.add_argument("--naive-analyzer", action="store_true",
                    help="the reference's pessimistic count; the port's only analyzer "
                         "(no VMEM-residency rule on the card), so every record says "
                         "analyzer=naive with or without it")
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--out", default="perf_iterations.json")
    args = ap.parse_args(argv)

    if args.arch is not None:
        if args.shape is None:
            ap.error("--arch requires --shape")
        cell_probe_main(args)
        return 0
    calibrate_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
