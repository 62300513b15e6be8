"""The same per-rank programs over ``torch.distributed`` (gloo, CPU ranks).

Each test spawns one world of processes, one mesh rank each
(``Mesh(..., rank=r)``: ``ppermute`` is ``batch_isend_irecv``, the gathers
``all_gather`` into one tensor and the sums ``all_reduce`` on the axis'
subgroup), rendezvousing through a ``FileStore`` under the test's own
temporary directory, so parallel test workers never share a port.  Every
rank's output must equal the single-controller mesh's (ranks as threads of
this process) within fp32 2e-5.  Each world has its own time limit: a hung
rank fails the test instead of holding the suite.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.dist import Mesh, symmetric_matmul

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
WORLD_TIMEOUT_S = 240
SHAPES = [(32, 64, 48), (30, 27, 19)]      # divisible, ragged
WORLDS = {
    4: [((2, 2), ("x", "y"), "cannon", False), ((2, 2), ("x", "y"), "cannon", True),
        ((2, 2), ("x", "y"), "summa", False), ((2, 2), ("x", "y"), "summa", True),
        ((2, 2), ("x", "y"), "ring_ag", None), ((2, 2), ("x", "y"), "ring_rs", None),
        ((4,), ("t",), "ring_ag", None), ((4,), ("t",), "ring_rs", None)],
    8: [((2, 2, 2), ("pod", "x", "y"), "cannon25d", False),
        ((2, 2, 2), ("pod", "x", "y"), "cannon25d", True),
        ((2, 2, 2), ("pod", "x", "y"), "pod25d", False),
        ((2, 2, 2), ("pod", "x", "y"), "pod25d", True),
        ((2, 2, 2), ("tree", "x", "y"), "fattree", None)],
}

_WORKER = r"""
import sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist import Mesh, symmetric_matmul

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cases = eval(sys.argv[4])
shapes = eval(sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank,
                        world_size=world, timeout=timedelta(seconds=120))
data = np.load(f"{tmp}/in.npz")
out = {}
for i, (sizes, names, strategy, overlap) in enumerate(cases):
    mesh = Mesh(sizes, names, device="cpu", rank=rank)
    for si in range(len(shapes)):
        a = torch.from_numpy(data[f"a{si}"])
        b = torch.from_numpy(data[f"b{si}"])
        out[f"{i}-{si}"] = symmetric_matmul(a, b, mesh=mesh, strategy=strategy,
                                            overlap=overlap).numpy()
np.savez(f"{tmp}/out{rank}.npz", **out)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def _operands():
    out = {}
    for si, (m, k, n) in enumerate(SHAPES):
        rng = np.random.default_rng(20 + si)
        out[f"a{si}"] = rng.standard_normal((m, k), dtype=np.float32)
        out[f"b{si}"] = rng.standard_normal((k, n), dtype=np.float32)
    return out


def _run_world(world, cases, tmp):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(tmp),
                               repr(cases), repr(SHAPES)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env)
             for r in range(world)]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f"world of {world} ranks did not finish in {WORLD_TIMEOUT_S}s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(logs):
        assert rc == 0 and f"RANK_OK {r}" in out, f"rank {r}: rc {rc}\n{err[-3000:]}"
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(world)]


@pytest.mark.timeout(WORLD_TIMEOUT_S + 60)
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_gloo_ranks_match_single_controller(tmp_path, world):
    cases = WORLDS[world]
    data = _operands()
    np.savez(tmp_path / "in.npz", **data)
    outs = _run_world(world, cases, tmp_path)
    for i, (sizes, names, strategy, overlap) in enumerate(cases):
        mesh = Mesh(sizes, names, device="cpu")
        for si in range(len(SHAPES)):
            want = symmetric_matmul(torch.from_numpy(data[f"a{si}"]),
                                    torch.from_numpy(data[f"b{si}"]), mesh=mesh,
                                    strategy=strategy, overlap=overlap).numpy()
            for r, got in enumerate(outs):
                g = got[f"{i}-{si}"]
                assert g.shape == want.shape
                assert np.max(np.abs(g - want)) < TOL, (strategy, overlap, sizes, si, r)
