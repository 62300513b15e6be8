"""Run one cell of the benchmark of ``repro_torch`` once on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device`` and,
traced, ``breakdown``; last, ``checks``: each number that decided
``correct`` beside its limit, also printed as the last lines of standard
error.  No result, and a non-zero exit, where there is no CUDA card, where
the program cannot be imported, or where JAX or the JAX package was loaded.

Run from the root of a checkout; the program is ``src/repro_torch``.  Its
kernels build into ``build/repro_torch/`` of the checkout (the program's
own fixed place), so only a checkout's first run compiles.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: this benchmark runs on an NVIDIA GPU", file=sys.stderr)
        return EXIT_NO_CARD
    from portbench import harness, spec

    ctx = harness.load(args.workload, args.seed, "cuda")
    need = spec.cell(spec.benchmark(), args.workload)["chips"]
    if torch.cuda.device_count() < need:
        print(f"the cell needs {need} cards, {torch.cuda.device_count()} found", file=sys.stderr)
        return EXIT_NO_CARD
    metrics = spec.metrics_of(spec.benchmark(), args.workload)
    try:
        result = harness.run(ctx, metrics["end_to_end"], metrics["per_layer"], args.seconds,
                             bool(args.trace), STARTED)
    except harness.ForbiddenModules as e:
        print(e, file=sys.stderr)
        return EXIT_FORBIDDEN
    found = harness.forbidden_modules()
    if found:
        print(harness.ForbiddenModules(found), file=sys.stderr)
        return EXIT_FORBIDDEN
    phases = result.pop("setup_phases")
    print(json.dumps(result), flush=True)
    print("setup " + json.dumps(phases), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
