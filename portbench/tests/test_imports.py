"""What the benchmark may load: nothing of JAX or the JAX package
(``repro``) anywhere under ``portbench/``, compared by whole top-level
names, since the port's name ``repro_torch`` begins with ``repro``;
nothing of the program under ``portbench/reference/``."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FILES = sorted(HERE.rglob("*.py"))


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & {"repro_torch", "repro", "portbench"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]; import portbench.reference.decoder, "
            "portbench.reference.compare; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('repro_torch', 'repro', 'jax')))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_probe", sys)
    assert "repro_torch_fake_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_probe", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert {"repro.fake_probe", "jax"} <= set(harness.forbidden_modules())


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """Run from a directory that holds only ``BENCHMARK.json`` and
    ``portbench/``: a non-zero exit and nothing on standard output (here,
    without a card, the first refusal; on the card, the missing program)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, *cmd[1:], "--workload", "danube-prefill-32k",
                          "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
