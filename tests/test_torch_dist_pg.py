"""The same per-rank programs over ``torch.distributed`` (gloo, CPU ranks).

Each test spawns one world of processes, one mesh rank each
(``Mesh(..., rank=r)``: ``ppermute`` is ``batch_isend_irecv``, the gathers
``all_gather`` into one tensor and the sums ``all_reduce`` on the axis'
subgroup), rendezvousing through a ``FileStore`` under the test's own
temporary directory, so parallel test workers never share a port.  Every
rank's output must equal the single-controller mesh's (ranks as threads of
this process) within fp32 2e-5.  A world of 4 also trains the smoke Llama
for two steps on a (data 2, model 2) mesh, one rank a process: each
process's losses equal the single controller's, and each holds only its
own rank's blocks of the state.  A world of 4 also holds the deferred
ppermute to its contract (a start returns while its peer has not sent yet,
its done gives the peer's bits), and worlds of 4 and 8 run each
overlapped body, whose prefetches are then in flight over gloo under the
multiply, bitwise equal to its blocking twin in the same process.  Each
world has its own time limit: a hung rank fails the test instead of
holding the suite.
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


def _run_world(world, cases, tmp, worker=_WORKER):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r), str(world), str(tmp),
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


# (mesh sizes, names, strategy, overlap): every body that defers its
# prefetches, and its world
DEFERRED = {4: [((2, 2), ("x", "y"), "cannon", True), ((2, 2), ("x", "y"), "summa", True),
                ((2, 2), ("x", "y"), "ring_ag", None), ((4,), ("t",), "ring_ag", None)],
            8: [((2, 2, 2), ("pod", "x", "y"), "cannon25d", True),
                ((2, 2, 2), ("pod", "x", "y"), "pod25d", True)]}
PEER_SLEEP_S = 0.5

_DEFERRED_WORKER = r"""
import sys, time
from datetime import timedelta
from unittest import mock
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist import Mesh, _collectives, symmetric_matmul

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cases = eval(sys.argv[4])
shapes = eval(sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank,
                        world_size=world, timeout=timedelta(seconds=120))
out = {}
if world == 4:
    # rank 0 sleeps before its start, which sends to rank 1
    ring = Mesh((4,), ("t",), device="cpu", rank=rank)
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(64, dtype=np.float32))

    def body(x):
        if rank == 0:
            time.sleep(%(sleep)r)
        t0 = time.perf_counter()
        started = _collectives.ppermute_start(x, "t", [(i, (i + 1) %% 4) for i in range(4)])
        t1 = time.perf_counter()
        got = _collectives.ppermute_done(started)
        return got, t1 - t0, time.perf_counter() - t0

    dist.barrier()
    got, start_s, done_s = ring.run(body, {rank: (x,)})[rank]
    out.update(sent=x.numpy(), got=got.numpy(), start_s=start_s, done_s=done_s)
start, done = _collectives.ppermute_start, _collectives.ppermute_done
data = np.load(f"{tmp}/in.npz")
for i, (sizes, names, strategy, overlap) in enumerate(cases):
    mesh = Mesh(sizes, names, device="cpu", rank=rank)
    a, b = torch.from_numpy(data["a0"]), torch.from_numpy(data["b0"])
    out[f"ov{i}"] = symmetric_matmul(a, b, mesh=mesh, strategy=strategy,
                                     overlap=overlap).numpy()
    with mock.patch.object(_collectives, "ppermute_start",
                           lambda x, axis_name, perm: done(start(x, axis_name, perm))), \
            mock.patch.object(_collectives, "ppermute_done", lambda finished: finished):
        out[f"twin{i}"] = symmetric_matmul(a, b, mesh=mesh, strategy=strategy,
                                           overlap=overlap).numpy()
    if strategy in ("cannon", "cannon25d"):
        out[f"staged{i}"] = symmetric_matmul(a, b, mesh=mesh, strategy=strategy,
                                             overlap=False).numpy()
np.savez(f"{tmp}/out{rank}.npz", **out)
dist.destroy_process_group()
print("RANK_OK", rank)
""" % {"sleep": PEER_SLEEP_S}


@pytest.mark.timeout(WORLD_TIMEOUT_S + 60)
@pytest.mark.parametrize("world", sorted(DEFERRED))
def test_gloo_deferred_permutes_are_in_flight_and_bitwise_their_twins(tmp_path, world):
    """World of 4: rank 0 sleeps ``PEER_SLEEP_S`` before its start, which
    sends to rank 1.  Rank 1's start returns before rank 0 has sent (well
    inside the sleep), its done only after, with rank 0's bits.  Worlds
    of 4 and 8: each overlapped body's output, its prefetches in flight
    over gloo, is bitwise its blocking twin's (every done right after its
    start) and, for cannon and cannon25d, the staged body's."""
    cases = DEFERRED[world]
    np.savez(tmp_path / "in.npz", **_operands())
    outs = _run_world(world, cases, tmp_path, worker=_DEFERRED_WORKER)
    if world == 4:
        assert float(outs[1]["start_s"]) < PEER_SLEEP_S / 2, outs[1]["start_s"]
        assert float(outs[1]["done_s"]) > PEER_SLEEP_S / 2, outs[1]["done_s"]
        for r, got in enumerate(outs):
            assert np.array_equal(got["got"], outs[(r - 1) % 4]["sent"]), r
    for r, got in enumerate(outs):
        for i, (sizes, names, strategy, overlap) in enumerate(cases):
            assert np.array_equal(got[f"ov{i}"], got[f"twin{i}"]), (strategy, sizes, r)
            if f"staged{i}" in got:
                assert np.array_equal(got[f"ov{i}"], got[f"staged{i}"]), (strategy, sizes, r)
            if r:
                assert np.array_equal(got[f"ov{i}"], outs[0][f"ov{i}"]), (strategy, sizes, r)


_TRAIN_WORKER = r"""
import dataclasses, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_iterator
from repro_torch.dist import Mesh
from repro_torch.models.registry import build_model
from repro_torch.runtime.train import TrainConfig, Trainer
from repro_torch.tree import tree_leaves

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank,
                        world_size=world, timeout=timedelta(seconds=120))
cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), dtype="float32")
mesh = Mesh((2, 2), ("data", "model"), device="cpu", rank=rank)
dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
try:
    Trainer(build_model(cfg), TrainConfig(), mesh=mesh, capture=True)
    refused = ""
except NotImplementedError as e:
    refused = str(e)
trainer = Trainer(build_model(cfg), TrainConfig(steps=2, lr=1e-3, warmup=1, log_every=1),
                  mesh=mesh)
out = trainer.fit(torch.Generator().manual_seed(0), batch_iterator(dc))
own = all(sorted(x.blocks) == [rank] for x in tree_leaves(out["state"]))
np.savez(f"{tmp}/out{rank}.npz", losses=np.array([h["loss"] for h in out["history"]]),
         own=np.array(own), refused=np.array(refused), eager=np.array(not trainer.capture))
dist.destroy_process_group()
print("RANK_OK", rank)
"""


@pytest.mark.timeout(WORLD_TIMEOUT_S + 60)
def test_gloo_ranks_train_as_the_single_controller(tmp_path):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, batch_iterator
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.train import TrainConfig, Trainer

    outs = _run_world(4, [], tmp_path, worker=_TRAIN_WORKER)
    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), dtype="float32")
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    want = [h["loss"] for h in Trainer(
        build_model(cfg), TrainConfig(steps=2, lr=1e-3, warmup=1, log_every=1),
        mesh=mesh).fit(torch.Generator().manual_seed(0), batch_iterator(dc))["history"]]
    mesh.close()
    for r, got in enumerate(outs):
        assert bool(got["own"]), f"rank {r} holds blocks of other ranks"
        # capture in a process group is refused, and the default steps eagerly
        assert "ROADMAP queue 1 item 2" in str(got["refused"]) and bool(got["eager"]), r
        assert got["losses"].shape == (2,)
        assert np.max(np.abs(got["losses"] - want)) < TOL, (r, got["losses"], want)
