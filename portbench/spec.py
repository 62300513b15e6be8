"""Finding a cell's parts by name: the entry of ``BENCHMARK.json``, its
workload file, its configuration, its traffic mix, its driver and its
per-layer metric readers.  Adding a cell, a configuration, a traffic mix
or a metric adds files; none here needs an edit."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def config(name: str) -> Dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{name}.json")


def workload_file(name: str) -> Dict:
    return _json(HERE / "workloads" / f"{name}.json")


def cell(bench: Dict, name: str) -> Dict:
    """The cell's ``BENCHMARK.json`` entry."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: Dict, name: str) -> Dict[str, List[Dict]]:
    """The cell's end-to-end and per-layer metrics: those that list it, or
    list no cells (a per-layer one without a list goes with every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per}


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"portbench.drivers.{kind}")


def traffic_kind(kind: str) -> ModuleType:
    return importlib.import_module(f"portbench.traffic.{kind}")


def reference(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.reference.{name}")


def metric_reader(name: str) -> ModuleType:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
