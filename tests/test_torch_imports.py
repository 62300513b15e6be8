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
from repro_torch.checkpoint import params_from_jax, state_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import device_put_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import build_model
from repro_torch.runtime.train import TrainConfig, Trainer

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
               "repro_torch.launch.perf_probe", "repro_torch.tree",
               "repro_torch.optim.adamw", "repro_torch.data.pipeline",
               "repro_torch.checkpoint.store", "repro_torch.runtime.train",
               "repro_torch.launch.train", "repro_torch.layers.moe",
               "repro_torch.configs.deepseek_moe_16b", "repro_torch.configs.qwen3_moe_30b_a3b",
               "repro_torch.configs.minicpm3_4b", "repro_torch.configs.granite_20b",
               "repro_torch.configs.chameleon_34b", "repro_torch.layers.mamba2",
               "repro_torch.layers.xlstm", "repro_torch.layers.ring_blocks",
               "repro_torch.models.hybrid", "repro_torch.models.xlstm_model",
               "repro_torch.models.encdec", "repro_torch.configs.zamba2_2_7b",
               "repro_torch.configs.xlstm_350m", "repro_torch.configs.seamless_m4t_medium",
               "repro_torch.runtime.sharding", "repro_torch.models.sharding_rules",
               "repro_torch.runtime.elastic", "repro_torch.optim.compress",
               "repro_torch.launch.mesh", "repro_torch.roofline",
               "repro_torch.roofline.hlo_stats", "repro_torch.roofline.analysis",
               "repro_torch.launch.specs", "repro_torch.launch.dryrun",
               "repro_torch.launch.report", "repro_torch.examples",
               "repro_torch.examples.quickstart", "repro_torch.examples.distributed_matmul",
               "repro_torch.examples.serve_batched", "repro_torch.examples.train_lm",
               "repro_torch.configs.deepseek_v2_lite"]


@pytest.mark.parametrize("name", NEW_MODULES)
def test_the_hygiene_walk_covers_the_measurement_loop(name):
    """The subprocess walk above imports every module of the package; the
    measurement loop's, the training path's and the layer zoo's modules
    (the recurrent and encoder-decoder families and the ring-TP block
    too), the sharded trainer's, and the roofline and dry run's are among
    them."""
    import pkgutil

    import repro_torch

    walked = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert name in walked
    assert any(path.replace("/", ".").endswith(name.split(".", 1)[1] + ".py")
               or path.replace("/", ".").endswith(name.split(".", 1)[1] + ".__init__.py")
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
                                   "params_from_jax", "launch_serve", "launch_train",
                                   "trainer", "device_put_batch", "state_from_jax"])
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
        elif entry == "launch_serve":
            launch_serve.main(["--smoke", "--max-new", "2"])
        elif entry == "launch_train":
            launch_train.main(["--smoke", "--steps", "2"])
        elif entry == "trainer":
            Trainer(build_model(cfg), TrainConfig())
        elif entry == "device_put_batch":
            device_put_batch({"tokens": np.zeros((1, 2), np.int32)})
        else:
            state_from_jax({"step": np.int32(0)}, cfg)
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
