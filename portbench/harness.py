"""One run of one cell: set-up, the measured window, in a traced run the
per-layer readings, the check against the plain reference, and the result.

The measured window is never profiled.  A traced run then profiles a
stretch of its own (``Driver.traced``: a few forwards, or one batch), so
the profiler's cost stays out of every number taken from the window.

``run`` takes the cell's parts already loaded, so a test can drive it on
the CPU at a small size; ``run.py`` loads them by name and looks for the
card first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
import time
from typing import Dict, List, Tuple

import torch

from portbench import profiler, spec

# top-level module names the process may not hold once the window has
# closed: JAX, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a driver and a metric reader see of the run."""
    name: str
    config: Dict              # configs/<config>.json
    model: Dict               # its ``model``, with the workload's overrides
    workload: Dict            # workloads/<cell>.json
    traffic: Dict             # traffic/<traffic>.json
    seed: int
    device: torch.device
    traced: bool = False      # a --trace 1 run: the window may also time its steps
    stats: Dict = dataclasses.field(default_factory=dict)    # the window's counts
    trace: Dict = dataclasses.field(default_factory=dict)    # the traced stretch
    extras: Dict = dataclasses.field(default_factory=dict)   # drivers/<kind>.py, traced


def load(name: str, seed: int, device) -> Context:
    """The cell ``name``'s parts, found by name."""
    bench = spec.benchmark()
    entry = spec.cell(bench, name)
    config = spec.config(entry["config"])
    workload = spec.workload_file(name)
    model = {**config["model"], **workload.get("model", {})}
    return Context(name, config, model, workload, spec.traffic(entry["traffic"]), int(seed),
                   torch.device(device))


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@contextlib.contextmanager
def ranges(readers: Dict):
    """Every function a reader names in ``RANGES`` wrapped, where its
    callers look it up, in a ``record_function`` range of the reader's
    name for it."""
    from torch.profiler import record_function

    wanted = {}
    for mod in readers.values():
        for rng, targets in getattr(mod, "RANGES", {}).items():
            for module, attr in targets:
                wanted[rng, module, attr] = None
    saved = []
    try:
        for rng, module, attr in wanted:
            owner = importlib.import_module(module)
            real = getattr(owner, attr)

            def ranged(*args, _real=real, _name=rng, **kw):
                with record_function(_name):
                    return _real(*args, **kw)
            saved.append((owner, attr, real))
            setattr(owner, attr, ranged)
        yield
    finally:
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)


def judge(readings: Dict[str, float], checks: Dict) -> Tuple[Dict, bool]:
    """Each number a cell compares beside its limit, and whether all are
    within: a reading is correct where it is at most its limit."""
    out = {k: {"value": readings[k], "limit": c["limit"]} for k, c in checks.items()}
    return out, all(c["limit"] is not None and c["value"] <= c["limit"] for c in out.values())


def run(ctx: Context, e2e: List[Dict], per_layer: List[Dict], seconds: float, trace: bool,
        started: float) -> Dict:
    """Run the cell once; return the result line's object.  ``started``
    is the process's start on ``time.perf_counter``'s clock."""
    drv = spec.driver(ctx.workload["driver"]).Driver(ctx)
    drv.setup()
    setup_s = time.perf_counter() - started
    cuda = ctx.device.type == "cuda"
    ctx.traced = trace
    ctx.stats = drv.window(seconds)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in per_layer} if trace else {}
    if trace:
        with ranges(readers), profiler.traced() as prof:
            done = profiler.windowed(drv.traced)
        seen = profiler.Trace(prof)
        ctx.trace = {"ranges": seen.ranges(), "stats": done, **seen.timeline()}
        del prof, seen
        with ranges(readers):
            ctx.extras = drv.traced_extras()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    drv.release()
    checks, within = judge(drv.check(), ctx.workload["checks"])
    correct = ctx.stats["failed"] == 0 and within

    values = dict(drv.end_to_end(ctx.stats), setup_s=setup_s)
    metrics = {}
    for m in (per_layer if trace else e2e):
        v = readers[m["name"]].read(ctx) if trace else values[m["name"]]
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(ctx.stats["attempted"]),
              "failed": int(ctx.stats["failed"]), "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = ctx.trace["busy_s"]
        device["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
    result["setup_phases"] = getattr(drv, "phases", {})
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__("modules of JAX or the JAX package loaded: " + ", ".join(found))
        self.found = found
