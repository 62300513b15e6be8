"""The port stands alone: it imports neither JAX nor anything of ``repro``,
and its entry points refuse to fall back to the CPU unasked."""
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
