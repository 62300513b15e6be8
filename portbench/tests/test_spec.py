"""BENCHMARK.json and the files it names: each found by name, within the
contract's limits of names, units and keys, every per-layer metric moving
an end-to-end metric its cells report, every reader and range it wraps
present."""
from __future__ import annotations

import importlib
import re

import pytest

from portbench import spec
from portbench.traffic import batches

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    entry = spec.cell(BENCH, cell)
    assert entry["chips"] == 1
    cfg = spec.config(entry["config"])
    assert cfg["name"] == entry["config"]
    traffic = spec.traffic(entry["traffic"])
    spec.traffic_kind(traffic["kind"])
    wl = spec.workload_file(cell)
    drv = spec.driver(wl["driver"])
    assert hasattr(drv, "Driver")
    spec.reference(cfg["reference"])
    assert wl["checks"] and all(c["limit"] is not None for c in wl["checks"].values())
    metrics = spec.metrics_of(BENCH, cell)
    names = {m["name"] for m in metrics["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert metrics["per_layer"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    cfg = spec.config(entry["name"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert cell in e2e[metric["moves"]].get("workloads", [cell])
    reader = spec.metric_reader(metric["name"])
    assert callable(reader.read)
    for targets in getattr(reader, "RANGES", {}).values():
        for module, attr in targets:
            assert callable(getattr(importlib.import_module(module), attr))


def test_layers_named_alike():
    """Metrics of one layer give the same ``layer`` letter for letter."""
    by_prefix = {}
    for m in BENCH["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_smoke_sizes_in_its_own_files(cell):
    """The tests run each cell at the small sizes its configuration,
    traffic and workload files give, so adding a cell edits no test."""
    entry = spec.cell(BENCH, cell)
    cfg = spec.config(entry["config"])
    assert cfg["smoke"]["family"] == cfg["model"]["family"]
    assert set(spec.traffic(entry["traffic"]).get("smoke", {})) <= set(spec.traffic(entry["traffic"]))
    wl = spec.workload_file(cell)
    assert set(wl.get("smoke", {})) <= set(wl)


def test_sharegpt_lengths_keep_the_published_mean():
    """Every batch holds the lognormal's quantiles; their mean, after the
    cut to the bucket, stays within 5 % of the source's mean input."""
    params = spec.traffic("batch64-sharegpt")
    lens = batches.lengths(params)
    assert len(lens) == params["batch"]
    assert min(lens) >= params["prompt_min"] and max(lens) <= params["prompt_max"]
    assert abs(sum(lens) / len(lens) - params["prompt_mean"]) < 0.05 * params["prompt_mean"]
