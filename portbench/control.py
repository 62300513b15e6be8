"""The readings that set a cell's limits, on the card, in one process:

    python3 portbench/control.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...]

For each seed, new weights and traffic drawn into the program's tensors
(its captured steps stay), one short window (one forward, or one batch),
and the numbers the cell's check compares: the program's readings.  For
each control seed, also the control's: the plain reference computed with
every product's operands in float8 e4m3, the precision below the
configurations' bfloat16, in the program's place.  Each side's readings are
held to the cell's limits by the comparison a run makes (``harness.judge``)
and the line says whether they pass: ``program_correct``,
``control_correct``.  The benchmark's own runs never run the control.  One
JSON line a seed on standard output, then a summary: the program's largest
reading (the lower end of a limit) and the control's smallest (the upper
end).  Exits 1 where the control passes on some seed, or the program fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    from portbench import harness, spec

    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    ctx = harness.load(args.workload, seeds[0], "cuda")
    drv = spec.driver(ctx.workload["driver"]).Driver(ctx)
    drv.setup()
    program, control = {}, {}
    checks = ctx.workload["checks"]
    control_passed = program_failed = False
    for seed in seeds:
        t0 = time.perf_counter()
        drv.reseed(seed)
        drv.window(0.0)
        t1 = time.perf_counter()
        got = drv.check(control=seed in args.control_seeds)
        row = {"seed": seed, **got, "window_s": t1 - t0, "check_s": time.perf_counter() - t1}
        mine = {k: v for k, v in got.items() if not k.startswith("control.")}
        low = {k[len("control."):]: v for k, v in got.items() if k.startswith("control.")}
        row["program_correct"] = harness.judge(mine, checks)[1]
        program_failed |= not row["program_correct"]
        if low:
            row["control_correct"] = harness.judge(low, checks)[1]
            control_passed |= row["control_correct"]
        print(json.dumps(row), flush=True)
        for name, value in mine.items():
            program.setdefault(name, []).append(value)
        for name, value in low.items():
            control.setdefault(name, []).append(value)
    summary = {name: {"program_max": max(v), "program_seeds": len(v),
                      "control_min": min(control[name]) if name in control else None,
                      "control_seeds": len(control.get(name, [])),
                      "limit": checks[name]["limit"] if name in checks else None}
               for name, v in program.items()}
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "summary": summary, "program_correct": not program_failed,
                      "control_correct": control_passed}), flush=True)
    return 1 if control_passed or program_failed else 0


if __name__ == "__main__":
    sys.exit(main())
