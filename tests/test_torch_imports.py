"""The port stands alone: it imports neither JAX nor anything of ``repro``,
and its entry points refuse to fall back to the CPU unasked."""
import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HYGIENE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "jaxlib", "repro.")))
print("MODULES", len(names), "BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("MODULES")][0]
    n, bad = line.split(" BAD ")
    assert int(n.split()[1]) >= 20, line
    assert bad == "[]", line


NEW_MODULES = ["repro_torch.obs.runtime", "repro_torch.obs.metrics", "repro_torch.obs.export",
               "repro_torch.obs.calibrate", "repro_torch.tune.table",
               "repro_torch.tune.search", "repro_torch.verify.drift",
               "repro_torch.launch.perf_probe"]


@pytest.mark.parametrize("name", NEW_MODULES)
def test_the_hygiene_walk_covers_the_measurement_loop(name):
    """The subprocess walk above imports every module of the package; the
    measurement loop's modules are among them."""
    import pkgutil

    import repro_torch

    walked = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert name in walked
    assert any(path.replace("/", ".").endswith(name.split(".", 1)[1] + ".py")
               for path in _port_sources())


def _port_sources():
    src = os.path.join(ROOT, "src")
    files = sorted(glob.glob(os.path.join(src, "repro_torch", "**", "*.py"), recursive=True))
    return [os.path.relpath(f, ROOT) for f in files] + ["chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_sources())
def test_no_import_of_jax_or_repro_anywhere_in_the_source(path):
    """Every import statement of the port and of ``chip_smoke.py``, those
    inside functions too (which importing the module does not run), names
    neither ``jax`` nor ``repro``."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = sorted(m for m in _imported_modules(tree)
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert bad == [], f"{path} imports {bad}"


@pytest.mark.parametrize("entry", ["resolve_device", "model_init",
                                   "params_from_jax", "launch_serve"])
def test_entry_points_raise_without_cuda(monkeypatch, entry):
    """Without device="cpu" the entry points ask for CUDA and raise where
    it is missing, instead of carrying on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3_2_1b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "resolve_device":
            resolve_device()
        elif entry == "model_init":
            build_model(cfg).init(torch.Generator().manual_seed(0))
        elif entry == "params_from_jax":
            params_from_jax({"layers": {"attn_norm": np.ones((2, 64), np.float32)}}, cfg)
        else:
            launch_serve.main(["--smoke", "--max-new", "2"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_launcher_serves_on_cpu_when_asked(capsys):
    assert launch_serve.main(["--smoke", "--device", "cpu", "--max-new", "3",
                              "--buckets", "4x16"]) == 0
    out = capsys.readouterr().out
    assert "bucket=4x16" in out and "zorder_matmul launches: 0" in out


def test_launcher_serves_plan_routed_on_cpu(capsys):
    assert launch_serve.main(["--smoke", "--device", "cpu", "--max-new", "3",
                              "--buckets", "4x16", "--mesh", "2x2", "--strategy", "summa"]) == 0
    out = capsys.readouterr().out
    assert "plan-routed on mesh {'x': 2, 'y': 2}: strategies {'summa+ov':" in out


def test_chip_smoke_refuses_to_run_without_cuda():
    """No card: a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
