#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no result line, non-zero exit):

1. build  -- compile the Z-order matmul kernel (K1: its wide, thin and
   wmma/fma sources, one nvcc each) and the flash-attention kernel (K2) from
   their ``csrc/``, all at once, and print ptxas's registers and spills.
2. kernel -- K1 against its plain version on the card at every (M, K, N)
   Llama-3.2-1B's serving path gives it (M in 4, 8, 64, 256), ragged shapes
   and shapes on both sides of each route threshold (m = 16 | 17,
   ``THIN_MAX_M`` | + 1), fp32 (1e-4 relative) and bf16 (2e-2 relative):
   each shape's route is logged and must be the one meant for it (wide,
   thin, wmma or fma), both tile orders and a second launch must agree
   bitwise.  Then K1's time per bf16 shape beside its bound, the plain
   version's time and ``torch.matmul``'s (the yardstick, which the port
   never calls), and the thin and wide routes (both wide tiles) side by
   side at M = 64-256, the measurement that sets ``THIN_MAX_M``.  Times
   are CUDA-event times of CUDA-graph replays, cycling through enough
   copies of the weight matrix that it comes from device memory, not L2,
   as in decoding.
3. model  -- a full-width, 2-layer Llama-3.2-1B in fp32: prefill + one
   decode step on the card through K1 and on the CPU through the plain
   version with the same weights; logits agree to 1e-3 relative.
4. serve  -- the full Llama-3.2-1B (16 layers, bf16, random weights from a
   seeded generator) behind ``Server``: warmup over buckets (4,16) and
   (8,32), each bucket run eagerly once and its prefill and decode step
   captured as CUDA graphs; then ``generate`` on 4 variable-length prompts
   with 16 new tokens, twice, by graph replays, with identical tokens,
   each run replaying K1 exactly 112 x 16 times (7 projections x 16
   layers per forward, 1 prefill + 15 decode steps; counted as replays x
   each graph's launches at capture), all on the thin route; the eager
   path (``runtime.serve.decode_loop`` on the same bucket-padded batch)
   gives the same tokens bitwise.
   Prints TTFT, p50/p99 per-token latency and tokens/s for both, and the
   device time of one prefill and one decode step (CUDA-graph replays).
   K1's count on this main path runs from 0 before the server is built.
5. flash-kernel -- K2 against its plain version on the card on each of
   its three routes (``FLASH_CHECKS``): head dims 16-128 (Llama's 64,
   zamba2's 80, danube's 120, 128), GQA groups 1, 2 and 4, ragged S_q and
   S_kv, S_q > S_kv with a window (rows that see no key output 0), windows
   64, 200, 4032 and 4096, head slices of a fused tensor and the (BH, S, D)
   entry, and one K/V head broadcast to two (a head stride of 0, which TMA
   cannot read, so the mma route takes it); fp32 on the fma route, bf16 on
   the route ``kernel.route`` picks (wgmma for D >= 64 where TMA reads the
   tensors, mma otherwise) and, where that is wgmma, on the mma
   route too; each case's route is asserted and the wgmma route rerun
   bitwise.  Then K2 at the long-prefill shapes (S = 32768, danube's
   D = 120 with a 4096 window and Llama's D = 64 causal), bf16: both bf16
   routes held against the plain version (run head by head: all heads'
   scores at once would take 137 GB) and timed in turns beside the bound,
   the exp floor, the plain version's time and
   ``F.scaled_dot_product_attention``'s (the yardstick, with its backend
   named; the port never calls it).  Also K1 at the 7 projections of a
   danube layer at M = 32768 (the wide route): held against its plain
   version and timed beside ``torch.matmul``, its bound and the wide
   route's other tile (128 x 128).  Every kernel check holds each
   output row (the last dim) to a relative L2 error: ``ROW_TOL``.
6. long-prefill -- full-width h2o-danube-3-4b (24 layers, bf16, random
   weights from a seeded generator) with ``attn_impl="flash"``: ``forward``
   and ``loss`` on 32768 tokens, 24 K2 and 168 K1 launches per forward,
   every K2 launch on the wgmma route and every K1 launch on the wide route;
   logits of shape (1, 32768, 32000), finite, and within
   ``PREFILL_LOGITS_TOL`` of the same forward through the plain attention
   (``attn_impl="xla"``), while two wrong attention cores (the window
   ignored; the window one 64-key tile short) must land outside it; a
   2-layer full-width fp32 danube at S = 8192 within 1e-4 of the xla route;
   the forward's device time, K1's and K2's share and prefill tokens/s.
7. plan-sweep -- the plan engine (``repro_torch.plan``): every strategy
   pinned through ``symmetric_matmul``, staged and overlapped where the
   lowering has both, on single-controller meshes whose ranks are threads
   of this process on the one card (``PLAN_SWEEP_CELLS``: cannon, summa,
   ring_ag, ring_rs on 2x2; the rings on 4; cannon25d, pod25d and fattree
   on 2x2x2; the pod25d slab on 2), at danube's gate/up product
   (``PLAN_SWEEP_SHAPE``, bf16).  Each output row within ``PLAN_ROW_TOL`` of
   K1 alone on the same operands, every rank's product on the K1 route
   ``kernel.route`` names for its shape; two wrong programs (Cannon without
   its B skew, ring_ag writing each chunk to the wrong row slot) must land
   outside the limit.  Device ms by CUDA events against K1 alone, the
   operands' scatter alone, and the plan's cost words beside the bytes the
   collectives copied, which the untimed check run accounts for through
   the plan's trace (``repro_torch.verify``): for ppermute and all_gather
   the copied bytes must equal the trace's words times the element size
   each call carried, phase by phase (placement skew, movement, gather);
   psum is printed in both conventions (the copies into each rank, the
   trace's ring all-reduce), with no limit.
8. planned-serve -- phase 4's workload through ``Server(mesh=2x2)``, each
   bucket's steps captured with the rank threads launching on the
   capturing stream and replayed: identical tokens across two runs and
   to the eager planned path on the same padded batch (bitwise), the planned
   prefill's last-token logits within ``PLANNED_LOGITS_TOL`` per row of
   ``mesh=None`` (a ring_rs reducing the wrong way round must land
   outside), token agreement with ``mesh=None`` printed, the strategies
   taken, K1 launches by route, TTFT, p50/p99, tokens/s for both, and one
   decode step's device time by CUDA events, planned and not, and as a
   captured planned step.  A failed capture fails the run.
9. planned-prefill -- phase 6's danube forward at S = 32768 on the 2x2
   mesh: all 168 products planned, the strategy counts, K1 launches all
   wide and K2's 24 all wgmma; logits within ``PREFILL_LOGITS_TOL`` per row
   of the unplanned forward, with Cannon without its B skew and the
   wrong-way ring_rs (each in every product of its strategy) outside;
   device ms against the unplanned forward, in turns.
10. conformance -- the conformance checker (``repro_torch.verify``) over
   the executed schedules, every leg fatal: ``run_matrix`` on the card
   (every catalog cell up to 16 ranks, square, ragged and batched, fp32
   and bf16, staged and overlapped), every row ok; every plan phases 7-9
   left in the plan cache (the sweep's, Llama's on 2x2, danube's on 2x2)
   passes ``check(plan, measure=True)``; one planned Llama decode step and
   one planned danube forward at S = 32768 under ``intercept()`` execute
   exactly the summed traces of the plans they ran; a swapped movement
   permutation is caught statically and, executed on the card, at the
   interceptor, and so is Cannon without its B skew.  Seconds per leg
   and K1's launches by route.  Only this phase and phase 7's untimed
   check run go through the interceptor; no timed run does.

11. calibrate + tune -- ``python -m repro_torch.launch.perf_probe`` (its
   ``main``) on a 2x2 rank-thread mesh: ring ppermutes per axis and a
   local copy fitted to α–β, K1's peak at 8192^3 bf16, and the K1
   autotune over Llama's serving shapes (unplanned decode and prefill, and
   each planned product's per-rank block product on 2x2), every compiled
   block shape x both orders, each candidate's first call held against
   the plain version, a winner kept only if it beats the default blocks by
   more than the timing noise; the profile (platform and device kind the
   card's, links labelled as device copies between rank threads) and the
   table (keyed by the card's name) saved to ``chiprun_out/``; each
   winner's blocks, order, route and time beside ``default_blocks``' at
   the same shape; ``Server(mesh=2x2, tuning=tuner)`` captured, its tokens
   identical across two runs and to the eager tuned planned path
   (bitwise); every K1 call of that eager run at its own shape, blocks
   and order (each a tuned plan's) within ``ROW_TOL`` of the plain
   version; its prefill and every decode step's logits, fed the same
   tokens, within ``PLANNED_LOGITS_TOL`` per row of the untuned planned
   path's; and ``build_plan(profile=)``'s strategy at Llama's and danube's
   shapes beside the TPU constants' picks.
12. obs + drift -- ``check_drift(device=cuda)`` with phase 11's profile as
   the stored one: on each of the 7 drift cells the obs, interceptor and
   trace multisets are equal, and no ranking or tuning flip; then, under
   ``obs.observe()``, one ``generate`` of phase 4's workload (its warmup
   included) and one planned bf16 product per drift cell, each cell's obs
   multiset equal to its trace; the Perfetto trace and the metrics
   snapshot written to ``chiprun_out/``.
13. profiler -- one unplanned and one planned (2x2) danube forward at
   S = 32768 under ``torch.profiler`` (no timed window is profiled):
   device time by kernel name into K1, K2 and the rest, the rest named by
   its top kernels and operators, and the planned forward's accumulate
   chain (fp32 zero, fp32 add, cast) and device copies beside the
   unplanned forward's; both traces saved gzipped to ``chiprun_out/``.

On one card the collectives are device copies and "overlap" is only the
order in which the rank threads issue work: no number of phases 7-9 or 11
is a link's.

Then a ``{"kernels": [...]}`` line (each kernel's entry with its launches
per route on each path, graph replays counted apart), the card's name and
power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.  The
full measurements go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gzip
import importlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from collections import Counter
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import param_device  # noqa: E402
from repro_torch.dist import Mesh, _collectives, symmetric_matmul  # noqa: E402
from repro_torch.dist.local import local_matmul  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, mha  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as k2  # noqa: E402
from repro_torch.kernels.matmul import _build, kernel as k1  # noqa: E402
from repro_torch.kernels.matmul import matmul, matmul_ref  # noqa: E402
from repro_torch.models.lm import cross_entropy  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.launch import perf_probe  # noqa: E402
from repro_torch.obs import calibrate  # noqa: E402
from repro_torch.plan import build_plan, execute_plan, planned_matmuls, plan_cache  # noqa: E402
from repro_torch.runtime.serve import (ServeConfig, batch_requests, decode_loop,  # noqa: E402
                                       planned_scope, token_loop)
from repro_torch.serve import Server, as_bucket, route as serve_route  # noqa: E402
from repro_torch.serve.server import DUMMY_TOKEN, PAD_ID  # noqa: E402
from repro_torch.verify import (ConformanceError, check, check_capture,  # noqa: E402
                                compare_records, intercept, measure_plan, run_matrix,
                                trace_plan)
from repro_torch.verify.conformance import CASES, _overlap_modes, matrix_cells  # noqa: E402
from repro_torch.tune import (Tuner, candidate_route, default_candidate, load_table,  # noqa: E402
                              time_candidate)
from repro_torch.verify.drift import DRIFT_CELLS, check_drift  # noqa: E402
from repro_torch.verify.interceptor import phase_bytes  # noqa: E402

# the module, not the function ``repro_torch.plan.lower_dist`` of its name
lower_dist_mod = importlib.import_module("repro_torch.plan.lower_dist")
plan_ir = importlib.import_module("repro_torch.plan.ir")

# H100 SXM published peaks (NVIDIA data sheet, dense): memory 3.35 TB/s,
# bf16 tensor cores 989 TFLOP/s, fp32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Per-row checks (``row_err``): the worst output row's relative L2 error.
# bf16: each side rounds its output to bf16 (2^-9 relative at most), and K2
# also rounds P to bf16 for its PV product (2^-9 of each probability), so a
# sound kernel reads a few 1e-3; a row that loses one 64-key tile of 4096
# moves by about sqrt(64 / 4096) ~ 0.1, ten times the limit.
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
MODEL_TOL = 1e-3
MS = (4, 8, 64, 256)
# (K, N) of the 7 projections of a Llama-3.2-1B layer: q, k, v, o, gate, up, down
LAYER_KN = [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
            (2048, 8192), (2048, 8192), (8192, 2048)]
MAIN_SHAPES = [(m, k, n) for m in MS for (k, n) in sorted(set(LAYER_KN))]
RAGGED = [(200, 300, 260), (8, 16, 8), (17, 300, 70), (1, 7, 3)]
# Both sides of each bf16 route threshold, and danube's n = 960 and K = 10240
THRESHOLD_SHAPES = [(16, 2048, 512), (17, 2048, 512), (k1.THIN_MAX_M, 2048, 512),
                    (k1.THIN_MAX_M + 1, 2048, 512), (64, 10240, 960), (300, 3840, 960)]
# The thin and wide routes side by side at these M (Llama's layer shapes)
CROSSOVER_MS = (64, 128, 192, 256)
CROSSOVER_BLOCKS = {"thin": (64, 64, 64), "wide": (128, 256, 64), "wide128": (128, 128, 64)}
L2_BYTES = 50 * 2 ** 20
SERVE_NEW = 16
SERVE_BUCKETS = [(4, 16), (8, 32)]
# K2 checks, (B, S_q, S_kv, H_q, H_kv, D, window, layout), all causal:
# Llama; danube with the window active; the reference's unaligned case;
# below the reference's _MIN_SEQ (D 16, mma); a 200-key window (D 32, mma);
# zamba2's D = 80 with GQA group 1; D = 128 with a 4032 window; S_q > S_kv
# with a window (the last rows see no key); head slices of one fused
# (B, S, H_q + 2 H_kv, D) tensor; the (BH, S, D) entry ``flash_attention``
FLASH_CHECKS = [(1, 4096, 4096, 32, 8, 64, 0, "bshd"), (1, 8192, 8192, 32, 8, 120, 4096, "bshd"),
                (2, 300, 512, 4, 2, 120, 0, "bshd"), (2, 200, 200, 4, 1, 16, 64, "bshd"),
                (1, 384, 384, 2, 2, 32, 200, "bshd"), (2, 1000, 1000, 8, 8, 80, 200, "bshd"),
                (1, 4500, 4500, 8, 2, 128, 4032, "bshd"), (1, 700, 300, 4, 1, 120, 64, "bshd"),
                (2, 384, 384, 8, 2, 120, 200, "slice"), (1, 520, 700, 8, 2, 64, 200, "heads"),
                (1, 600, 600, 8, 2, 120, 200, "expand")]
# K2 at the long-prefill path's shapes: danube (the path) and Llama
FLASH_TIMED = {"danube": (1, 32768, 32768, 32, 8, 120, 4096),
               "llama": (1, 32768, 32768, 32, 8, 64, 0)}
# The special-function units' exp2 rate: 16 a clock per SM (Hopper), at the
# card's maximum SM clock as nvidia-smi reports it.
EXP2_PER_CLOCK_PER_SM = 16
PREFILL_ARCH = "h2o-danube-3-4b"
PREFILL_S = 32768
FP32_CHECK_S = 8192
FP32_CHECK_LAYERS = 2
FP32_CHECK_TOL = 1e-4
# Full-width bf16 flash vs xla forward, worst logits row (``row_err``):
# the routes differ only in the attention core (K2 rounds P to bf16 for its
# PV product, the xla route keeps P in fp32), and each of 24 layers
# re-rounds the bf16 residual stream.  The limit sits between the sound
# route's reading (a few 1e-2 on an H100) and those of two wrong attention
# cores run beside it (``PREFILL_CONTROLS``, several 1e-1), which must land
# outside it.  The loss is printed, not held: with random weights it stays
# near ln(vocab) whatever attention does.
PREFILL_LOGITS_TOL = 1e-1
# window of each wrong core: 0 ignores the window, 4096 - 64 drops the
# oldest 64-key tile of every full window
PREFILL_CONTROLS = {"window ignored": 0, "window one tile short": 4096 - 64}
# Plan engine (phases 7-9).  The sweep's product: danube's gate/up
# projection at M = 8192 (a quarter of the long prefill's rows), bf16.
PLAN_SWEEP_SHAPE = (8192, 3840, 10240)
# (mesh sizes, axis names, strategy, overlap): every strategy, staged and
# overlapped where ``overlap_capability`` allows
PLAN_SWEEP_CELLS = [
    ((2, 2), ("x", "y"), "cannon", False), ((2, 2), ("x", "y"), "cannon", True),
    ((2, 2), ("x", "y"), "summa", False), ((2, 2), ("x", "y"), "summa", True),
    ((2, 2), ("x", "y"), "ring_ag", None), ((2, 2), ("x", "y"), "ring_rs", None),
    ((4,), ("t",), "ring_ag", None), ((4,), ("t",), "ring_rs", None),
    ((2, 2, 2), ("pod", "x", "y"), "cannon25d", False),
    ((2, 2, 2), ("pod", "x", "y"), "cannon25d", True),
    ((2, 2, 2), ("pod", "x", "y"), "pod25d", False),
    ((2, 2, 2), ("pod", "x", "y"), "pod25d", True),
    ((2, 2, 2), ("tree", "x", "y"), "fattree", None),
    ((2,), ("pod",), "pod25d", None),
]
# A planned product against K1 alone: the same bf16 operands, fp32
# accumulation either way, but the contraction summed in other pieces (a
# rank's block, the ring's partials) before one bf16 rounding, so rows read
# a few 1e-3 at most; a wrong program moves a whole block of every row
# (about 0.5 or more), far outside.
PLAN_ROW_TOL = 1e-2
# Planned serving (16 bf16 layers) against mesh=None, worst last-token
# logits row: each projection's output may differ from the unplanned one
# by a bf16 rounding (other summation pieces), and 16 layers carry that
# through the residual stream; the limit is the long prefill's, and a
# ring_rs reducing the wrong way round must land outside it.
PLANNED_LOGITS_TOL = 1e-1
PLANNED_MESH = ((2, 2), ("x", "y"))
# K1 launches per planned product on the 2x2 mesh, by strategy (ranks x
# block products per rank)
LAUNCHES_PER_PRODUCT_2X2 = {"cannon": 4 * 2, "summa": 4, "summa+ov": 4 * 2,
                            "ring_ag": 4 * 4, "ring_rs": 4}
OUT_DIR = os.path.join(ROOT, "chiprun_out")
# Calibration and tuning (phase 11): timed reps per probe and per candidate
CALIBRATE_REPS = 5
TUNE_REPS = 5
# (K, N) of the 4 distinct projections of a danube layer: q/o, k/v, gate/up, down
DANUBE_KN = [(3840, 3840), (3840, 960), (3840, 10240), (10240, 3840)]
# obs + drift (phase 12): one planned bf16 product per drift cell at this
# (M, K, N), under tracing
OBS_PRODUCT = (1024, 1024, 1024)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(m: int, k: int, n: int, dtype: torch.dtype):
    """(ms, "bytes" | "operations"): each input read once, the output
    written once, at the memory rate; or the FLOPs at the type's peak."""
    esize = torch.finfo(dtype).bits // 8
    t_bytes = (m * k + k * n + m * n) * esize / PEAK_BYTES_S
    t_ops = 2.0 * m * n * k / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def row_err(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Each row's (last dim's) relative L2 error ||out - ref|| / ||ref||:
    the worst (``row_rel``) and mean over rows, and the largest absolute
    error.  A row that is 0 in both reads 0.  Chunked, so a (32768, 32000)
    pair needs no fp32 copy of its own size."""
    o, r = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    step = max(1, 2 ** 26 // o.shape[1])
    rels, absmax = [], []
    for i in range(0, o.shape[0], step):
        rf = r[i:i + step].float()
        d = o[i:i + step].float() - rf
        rels.append(d.norm(dim=1) / rf.norm(dim=1).clamp_min(1e-30))
        absmax.append(d.abs().max())
    rel = torch.cat(rels)
    return {"row_rel": rel.max().item(), "row_rel_mean": rel.mean().item(),
            "max_abs_err": torch.stack(absmax).max().item(),
            "finite": bool(torch.isfinite(out).all())}


def graph_ms(fn, calls) -> float:
    """Mean device ms per call: capture ``calls`` (a list of argument
    tuples) in one CUDA graph, replay once to warm, time a second replay
    with CUDA events."""
    for args in calls[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in calls:
            fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / len(calls)


def phase_build() -> dict:
    """Build K1 and K2 at once (one nvcc per source file, all in parallel),
    load both, print ptxas's registers and spills per kernel instance."""
    t0 = time.perf_counter()
    mods = {"zorder_matmul": _build, "flash_attention": k2}
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        futs = {name: pool.submit(m.build) for name, m in mods.items()}
        paths = {name: f.result() for name, f in futs.items()}
    for m in mods.values():
        m.load()
    secs = time.perf_counter() - t0
    out = {"seconds": secs}
    for name, path in paths.items():
        ptxas = path.with_suffix(".log").read_text()
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")
        out[name] = {"library": path.name, "ptxas": ptxas}
    log(f"[build] {', '.join(p.name for p in paths.values())} ready in {secs:.1f}s")
    return out


def meant_route(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The route a product of fresh (16-byte aligned) tensors is meant to
    take: fp32 the fma kernel; bf16 with k and n multiples of 8 the thin
    route up to ``THIN_MAX_M`` rows and the wide route above; other bf16
    the wmma kernel."""
    if dtype == torch.float32:
        return "fma"
    if k == 0 or k % 8 or n % 8:
        return "wmma"
    return "thin" if m <= k1.THIN_MAX_M else "wide"


def routes_moved(before: dict) -> dict:
    return {r: v - before[r] for r, v in k1.launches_by_route.items() if v != before[r]}


def phase_kernel(dev: torch.device, gen: torch.Generator) -> dict:
    checks, timings = [], []
    worst_main_abs = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for (m, k, n) in MAIN_SHAPES + RAGGED + THRESHOLD_SHAPES:
            a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(dtype)
            before = dict(k1.launches_by_route)
            z = matmul(a, b, order="zorder")
            moved = routes_moved(before)
            r = matmul(a, b, order="rowmajor")
            again = matmul(a, b, order="zorder")
            ref = matmul_ref(a, b)
            torch.cuda.synchronize()
            want = meant_route(m, k, n, dtype)
            if moved != {want: 1}:
                raise AssertionError(f"{(m, k, n)} {dtype} launched {moved}, meant for {want}")
            if not torch.equal(z, r):
                raise AssertionError(f"orders disagree at {(m, k, n)} {dtype}")
            if not torch.equal(z, again):
                raise AssertionError(f"two launches disagree at {(m, k, n)} {dtype}")
            diff = (z.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-30)
            ok = rel < TOL[dtype] and bool(torch.isfinite(z).all())
            checks.append({"shape": [m, k, n], "dtype": str(dtype), "route": want,
                           "max_abs_err": diff, "rel_err": rel, "ok": ok})
            log(f"[kernel] {str(dtype)[6:]:8s} {m:4d}x{k:5d}x{n:5d} {want:4s} "
                f"max_abs_err={diff:.3e} rel={rel:.3e} orders and reruns bitwise equal "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version at "
                                     f"{(m, k, n)} {dtype}: rel {rel} >= {TOL[dtype]}")
            if dtype == torch.bfloat16 and (m, k, n) in MAIN_SHAPES:
                worst_main_abs = max(worst_main_abs, diff)
    for (m, k, n) in MAIN_SHAPES:
        a, calls = _decode_operands(dev, gen, m, k, n)
        t = {}
        # in turns: kernel, library, plain, plain, library, kernel
        for name in ("ms", "library_ms", "plain_ms", "plain_ms", "library_ms", "ms"):
            fn = {"ms": matmul, "library_ms": torch.matmul, "plain_ms": matmul_ref}[name]
            t.setdefault(name, []).append(graph_ms(fn, calls))
        bms, by = bound(m, k, n, torch.bfloat16)
        row = {"shape": [m, k, n], "dtype": "bfloat16", "route": meant_route(m, k, n, a.dtype),
               "weight_copies": len(calls), **{key: min(v) for key, v in t.items()}, "runs": t,
               "bound_ms": bms, "bound_by": by}
        row["bound_share"] = bms / row["ms"]
        timings.append(row)
        log(f"[kernel-time] bf16 {m:4d}x{k:5d}x{n:5d} K1 ({row['route']}) "
            f"{row['ms'] * 1e3:8.2f}us bound {bms * 1e3:7.2f}us ({by}, {row['bound_share']:.1%}) "
            f"torch.matmul {row['library_ms'] * 1e3:8.2f}us plain {row['plain_ms'] * 1e3:8.2f}us")
        del a, calls
    crossover = crossover_times(dev, gen)
    torch.cuda.empty_cache()
    return {"checks": checks, "timings": timings, "crossover": crossover,
            "worst_main_abs_err": worst_main_abs}


def _decode_operands(dev, gen, m, k, n):
    """A (m, k) activation and enough (k, n) weight copies that cycling
    through them reads the weights from device memory, not L2."""
    a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    copies = max(3, math.ceil(3 * L2_BYTES / (k * n * 2)))
    bs = [(torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
          for _ in range(copies)]
    return a, [(a, b) for b in bs]


def crossover_times(dev: torch.device, gen: torch.Generator) -> dict:
    """The thin route and both wide tiles on the same products, in turns, at
    Llama's layer shapes for each M in ``CROSSOVER_MS``: where the wide
    route overtakes the thin one sets ``THIN_MAX_M``."""
    rows, per_layer = [], {}
    for m in CROSSOVER_MS:
        by_kn = {}
        for (k, n) in sorted(set(LAYER_KN)):
            _, calls = _decode_operands(dev, gen, m, k, n)
            t = {}
            for name in ("thin", "wide", "wide128", "wide128", "wide", "thin"):
                bm, bn, bk = CROSSOVER_BLOCKS[name]

                def fn(a, b, bm=bm, bn=bn, bk=bk):
                    return matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
                t.setdefault(name, []).append(graph_ms(fn, calls))
            row = {"shape": [m, k, n], **{name: min(v) for name, v in t.items()},
                   "bound_ms": bound(m, k, n, torch.bfloat16)[0]}
            rows.append(row)
            by_kn[(k, n)] = row
            del calls
        per_layer[m] = {name: sum(by_kn[kn][name] for kn in LAYER_KN)
                        for name in (*CROSSOVER_BLOCKS, "bound_ms")}
        log(f"[kernel-crossover] M={m:3d}, one Llama layer (7 products): " + ", ".join(
            f"{name} {v * 1e3:.2f}us" for name, v in per_layer[m].items()))
    return {"rows": rows, "per_layer": per_layer, "thin_max_m": k1.THIN_MAX_M}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_model(dev: torch.device) -> dict:
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1), dev)
    cpu = torch.device("cpu")
    cpu_params = _to(params, cpu)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(2, 16)))
    offsets = torch.tensor([0, 5])          # row 1 is left-padded by 5 slots
    out = {}
    for name, p, d in (("card", params, dev), ("cpu", cpu_params, cpu)):
        cache = model.init_cache(2, 32, d)
        k1.reset_launches()
        with torch.no_grad():
            pre, cache = model.prefill(p, cache, tokens.to(d), offsets.to(d))
            nxt = pre.argmax(-1) if name == "card" else out["card"][2]
            dec, _ = model.decode_step(p, cache, nxt.to(d)[:, None], 16, offsets.to(d))
        out[name] = (pre.cpu(), dec.cpu(), nxt.cpu(), k1.launches)
    v = cfg.vocab_size
    errs = {}
    for i, what in ((0, "prefill"), (1, "decode")):
        g, c = out["card"][i][:, :v], out["cpu"][i][:, :v]
        if not (torch.isfinite(g).all() and g.shape == c.shape == (2, v)):
            raise AssertionError(f"{what} logits malformed: {tuple(g.shape)}")
        errs[what] = ((g - c).abs().max() / c.abs().max()).item()
    launches = out["card"][3]
    log(f"[model] 2-layer full-width fp32: prefill rel_err={errs['prefill']:.3e} "
        f"decode rel_err={errs['decode']:.3e} K1 launches on card={launches} "
        f"(plain version on the cpu: {out['cpu'][3]} launches)")
    if launches != 2 * 7 * 2 or out["cpu"][3] != 0:
        raise AssertionError(f"expected 28 K1 launches on the card, 0 on the cpu; "
                             f"got {launches}, {out['cpu'][3]}")
    if max(errs.values()) >= MODEL_TOL:
        raise AssertionError(f"card and cpu logits disagree: {errs}")
    del params, cpu_params
    torch.cuda.empty_cache()
    return {"rel_err": errs, "launches": launches}


def _run_row(tag: str, rep: int, vocab: int, *, bucket, graphs: bool, routes: dict,
             counted: dict, taken: dict, ttft_s: float, steps_s, wall_s: float,
             new_tokens: list) -> dict:
    """One served run's row (K1 launches by route, planned products by
    strategy, TTFT, p50 / p99, tokens/s, the new tokens), logged; every
    token must be in the vocabulary."""
    steps_s = np.asarray(steps_s)
    p50, p99 = (float(np.percentile(steps_s, q) * 1e3) for q in (50, 99))
    tps = sum(len(t) for t in new_tokens) / wall_s
    log(f"[{tag}] run {rep} ({'graph replays' if graphs else 'eager'}): bucket "
        f"{bucket} ttft {ttft_s * 1e3:.2f}ms p50 {p50:.3f}ms p99 {p99:.3f}ms {tps:.1f} tok/s; "
        f"K1 {routes}" + (f"; products {taken}" if taken else ""))
    for toks in new_tokens:
        if len(toks) != SERVE_NEW or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"malformed tokens {toks}")
    return {"bucket": bucket, "graphs": graphs, "launches": sum(routes.values()),
            "routes": routes, "counted": counted, "strategies": taken,
            "ttft_ms": ttft_s * 1e3, "p50_ms": p50, "p99_ms": p99, "tokens_per_s": tps,
            "wall_s": wall_s, "tokens": new_tokens}


def served_runs(server, prompts, reps: int, tag: str, vocab: int) -> list:
    """``reps`` runs of ``server.generate(prompts)``: per run the K1 launches
    by route (counted for an eager run, replays x each graph's capture for
    a captured one), the planned products by strategy, TTFT, p50 / p99 and
    tokens/s; every token in the vocabulary."""
    runs = []
    for rep in range(reps):
        k1.reset_launches()
        replayed = dict(server.cache_report()["kernels"]["zorder_matmul"]["replayed_by_route"])
        before = dict(server.plan_report()["strategies"])
        res = server.generate(prompts)
        counted = _nonzero(k1.launches_by_route)
        now = server.cache_report()["kernels"]["zorder_matmul"]["replayed_by_route"]
        routes = {r: counted.get(r, 0) + now.get(r, 0) - replayed.get(r, 0)
                  for r in sorted(set(counted) | set(now))}
        after = server.plan_report()["strategies"]
        taken = {st: v - before.get(st, 0) for st, v in after.items() if v != before.get(st, 0)}
        runs.append(_run_row(tag, rep, vocab, bucket=res.bucket, graphs=res.graphs,
                             routes=_nonzero(routes), counted=counted, taken=taken,
                             ttft_s=res.ttft_s, steps_s=res.step_latencies_s,
                             wall_s=res.wall_s, new_tokens=res.new_tokens))
    return runs


def eager_runs(model, params, sc, prompts, reps: int, tag: str, *, mesh=None, tuning=None,
               logits: list = None) -> list:
    """``reps`` runs of the eager path a captured ``Server`` is held to:
    ``runtime.serve.decode_loop`` on the batch the server routes
    ``prompts`` to (``batch_requests(prompts + dummies, pad_to=bucket.seq)``),
    in a fresh cache, under ``planned_scope(mesh, tuning=)``, timed as
    ``Server.generate`` times its runs.  Rows as ``served_runs``', each
    with the full (B, S + new) token array; ``logits`` (a list) collects
    the last run's prefill and decode-step logits."""
    dev = param_device(params)
    bucket = serve_route(len(prompts), max(len(p) for p in prompts),
                         [as_bucket(b) for b in SERVE_BUCKETS])
    dummies = [[DUMMY_TOKEN]] * (bucket.batch - len(prompts))
    batch, lens = batch_requests(list(prompts) + dummies, PAD_ID, pad_to=bucket.seq)
    sp = batch.shape[1]

    def mark():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    runs = []
    for rep in range(reps):
        k1.reset_launches()
        before = lower_dist_mod.executions_snapshot()
        t0 = time.perf_counter()
        tokens = torch.as_tensor(batch, dtype=torch.int64, device=dev)
        offsets = torch.as_tensor(sp - lens, dtype=torch.int64, device=dev)
        cache = model.init_cache(bucket.batch, sc.max_seq, dev)
        with torch.no_grad(), planned_scope(mesh, None, tuning):
            if logits is None:
                full, marks = decode_loop(model, params, cache, tokens, offsets, sc, None,
                                          on_token=mark)
            else:
                logits.clear()

                def keep(out):
                    logits.append(out)
                    return out

                full, marks = token_loop(
                    model, cache, tokens, sc, None,
                    prefill=lambda: keep(model.prefill(params, cache, tokens, offsets)[0]),
                    step=lambda cur, pos: keep(
                        model.decode_step(params, cache, cur, pos, offsets)[0]),
                    on_token=mark)
        wall = time.perf_counter() - t0
        counted = _nonzero(k1.launches_by_route)
        after = lower_dist_mod.executions_snapshot()
        taken = {st: v - before.get(st, 0) for st, v in after.items() if v != before.get(st, 0)}
        new = [full[i, sp - int(lens[i]):].tolist()[int(lens[i]):] for i in range(len(prompts))]
        row = _run_row(tag, rep, model.cfg.vocab_size, bucket=bucket.label, graphs=False,
                       routes=counted, counted=counted, taken=taken, ttft_s=marks[0] - t0,
                       steps_s=np.diff(np.asarray(marks)), wall_s=wall, new_tokens=new)
        row["full"] = full.tolist()
        runs.append(row)
    return runs


def path_counts(path: dict, runs: list) -> None:
    """Add the runs' counted K1 launches (none for graph replays) to the
    count the main path's warmup and captures left, and fail if the path
    launched K1 no time."""
    for r in runs:
        path["launches"] += sum(r["counted"].values())
        for route, v in r["counted"].items():
            path["routes"][route] = path["routes"].get(route, 0) + v
    if not path["launches"]:
        raise AssertionError("the main path launched K1 no time")


def phase_serve(dev: torch.device) -> dict:
    """Phase 4: Llama-3.2-1B behind ``Server``, each bucket's steps captured
    as CUDA graphs at warmup and replayed, against the eager path on the
    same bucket-padded batch: identical tokens."""
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    sc = ServeConfig(max_new_tokens=SERVE_NEW, max_seq=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in (5, 9, 12, 16)]
    per_forward = 7 * cfg.num_layers
    want = per_forward * SERVE_NEW
    # the main path: counts from 0 before the server is built, read after its runs
    k1.reset_launches()
    server = Server(model, params, sc, buckets=SERVE_BUCKETS)
    warm = server.warmup()
    path = {"launches": k1.launches, "routes": _nonzero(k1.launches_by_route)}
    log(f"[serve] {cfg.name}: {n_params / 1e9:.3f}B params bf16 in {init_s:.1f}s; warmup "
        + ", ".join(f"{k} {v['warm_s']:.2f}s + {v['graphs']} graphs captured in "
                    f"{v['capture_s']:.2f}s" for k, v in warm.items())
        + f"; K1 counted in warmup and captures {path['routes']}")
    runs = served_runs(server, prompts, 2, "serve", cfg.vocab_size)
    path_counts(path, runs)
    for r in runs:
        if not r["graphs"] or r["counted"] or r["routes"] != {"thin": want}:
            raise AssertionError(f"a captured run launched {r['routes']} (counted from Python "
                                 f"{r['counted']}), want {want} on the thin route by graph "
                                 f"replays ({per_forward} per forward x {SERVE_NEW} forwards)")
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError("two generate runs with the same seed disagree")
    alone = server.generate([prompts[2]])
    if alone.new_tokens[0] != runs[0]["tokens"][2]:
        raise AssertionError("a request served alone decodes differently from "
                             "the same request in a batch")
    eager = eager_runs(model, params, sc, prompts, 2, "serve")
    for r in eager:
        if r["graphs"] or r["routes"] != {"thin": want} or r["counted"] != r["routes"]:
            raise AssertionError(f"an eager run launched {r['routes']}, want {want} thin")
        if r["tokens"] != runs[0]["tokens"]:
            raise AssertionError("the captured steps' tokens differ from the eager path's")
    path["report"] = server.cache_report()
    log(f"[serve] tokens bitwise equal: graph replays, eager, a request served alone; "
        f"req0 tokens {runs[0]['tokens'][0][:8]}...; K1 on the main path: counted "
        f"{path['launches']} (warmup and captures), replayed "
        f"{path['report']['kernels']['zorder_matmul']['replayed']} "
        f"{path['report']['kernels']['zorder_matmul']['replayed_by_route']}")
    device_ms = step_device_ms(model, params, dev, SERVE_BUCKETS[0])
    summary = {name: {key: float(np.median([r[key] for r in rs]))
                      for key in ("ttft_ms", "p50_ms", "p99_ms", "tokens_per_s")}
               for name, rs in (("graphs", runs), ("eager", eager))}
    log(f"[serve] device time per step (CUDA-graph replay, bucket 4x16): prefill "
        f"{device_ms['prefill']:.3f}ms, decode {device_ms['decode']:.3f}ms; decode p50 on the "
        f"host clock: graph replays {summary['graphs']['p50_ms']:.3f}ms, eager "
        f"{summary['eager']['p50_ms']:.3f}ms; K1 per step by route: {device_ms['routes']}")
    for step, r in device_ms["routes"].items():
        if r != {"thin": per_forward}:
            raise AssertionError(f"one {step} step launched K1 {r}, want {per_forward} thin")
    del server, params
    torch.cuda.empty_cache()
    return {"params": n_params, "init_s": init_s, "warmup": warm, "runs": runs,
            "eager_runs": eager, "summary": summary, "path": path,
            "launches_per_generate": want, "step_device_ms": device_ms}


def step_device_ms(model, params, dev: torch.device, bucket) -> dict:
    """Device time of one prefill and one decode step at a bucket's shape:
    each captured in a CUDA graph and replayed, so host dispatch is out of
    the measurement (the eager step's host-clock time keeps it in)."""
    batch, seq = bucket
    cache = model.init_cache(batch, 64, dev)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(1, model.cfg.vocab_size, size=(batch, seq)))
    tokens = tokens.to(dev)
    offsets = torch.zeros(batch, dtype=torch.int64, device=dev)
    steps = {"prefill": lambda: model.prefill(params, cache, tokens, offsets),
             "decode": lambda: model.decode_step(params, cache, tokens[:, -1:], seq, offsets)}
    out = {"routes": {}}
    with torch.no_grad():
        for name, step in steps.items():
            k1.reset_launches()
            step()
            out["routes"][name] = {r: v for r, v in k1.launches_by_route.items() if v}
            out[name] = graph_ms(step, [()])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree

def event_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn()``: one warm call, then ``reps``
    calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: query i and key j both
    counted from 0, j <= i when causal, j > i - window when window > 0."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, i + 1) if causal else np.full(sq, skv, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(b, sq, skv, hq, hkv, d, window, dtype=torch.bfloat16):
    """(ms, "bytes" | "operations"): Q, K, V and O moved once at the memory
    rate, or 4 D flops per unmasked pair and query head at the type's peak."""
    esize = torch.finfo(dtype).bits // 8
    t_bytes = 2 * b * d * (sq * hq + skv * hkv) * esize / PEAK_BYTES_S
    t_ops = 4.0 * d * b * hq * attention_pairs(sq, skv, True, window) / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def exp_floor_ms(b, sq, skv, hq, window, dev: torch.device) -> float:
    """One exp2 per unmasked (query, key) pair and query head on the
    special-function units, at ``EXP2_PER_CLOCK_PER_SM`` a clock on every SM
    at the maximum SM clock.  Printed beside the bound, which it does not
    change."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rate = EXP2_PER_CLOCK_PER_SM * sms * max_sm_clock_hz()
    return b * hq * attention_pairs(sq, skv, True, window) / rate * 1e3


def key_tiles(sq, skv, window) -> dict:
    """The 128 x 128 tiles the wgmma route visits per (batch, head), and
    how many of them compare positions (``kernel.kv_tiles``)."""
    tiles = [t for q0 in range(0, sq, k2.BLOCK_M)
             for t in k2.kv_tiles(q0, sq, skv, True, window)]
    return {"tiles": len(tiles), "masked": sum(m for _, m in tiles)}


def _qkv(gen, dev, dtype, b, sq, skv, hq, hkv, d):
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


def _heads(x):  # (B, S, H, D) -> (B*H, S, D)
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])


def _bshd(x):  # (BH, S, D) -> a (1, S, BH, D) view
    return x.unsqueeze(0).transpose(1, 2)


def sdpa_yardstick(q, k, v, window: int):
    """``F.scaled_dot_product_attention`` on the same inputs, KV heads
    expanded for it beforehand: (callable, backend name).  Causal without
    a window takes the flash backend; a window needs a mask, which only the
    memory-efficient backend takes."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    if window == 0:
        backend, kw = SDPBackend.FLASH_ATTENTION, {"is_causal": True}
    else:
        i = torch.arange(q.shape[1], device=q.device)[:, None]
        j = torch.arange(k.shape[1], device=q.device)[None, :]
        backend, kw = SDPBackend.EFFICIENT_ATTENTION, {
            "attn_mask": (j <= i) & (j > i - window)}

    def run():
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)
    return run, backend.name


def _flash_case(gen, dev, dtype, case):
    """q, k, v of one ``FLASH_CHECKS`` case and ``run(route)``: the case's
    entry point with the route ``kernel.route`` picks (None) or a forced
    one, returning (B*H_q, S_q, D)."""
    b, sq, skv, hq, hkv, d, window, layout = case
    if layout == "slice":   # head slices of one fused tensor (S_q = S_kv)
        fused = torch.randn((b, sq, hq + 2 * hkv, d), generator=gen, device=dev).to(dtype)
        q, k, v = fused[:, :, :hq], fused[:, :, hq:hq + hkv], fused[:, :, hq + hkv:]
    elif layout == "expand":  # one K/V head broadcast (head stride 0) to H_kv heads
        q, k, v = _qkv(gen, dev, dtype, b, sq, skv, hq, 1, d)
        k, v = k.expand(b, skv, hkv, d), v.expand(b, skv, hkv, d)
    else:
        q, k, v = _qkv(gen, dev, dtype, b, sq, skv, hq, hkv, d)
    if layout == "heads":   # the reference's (BH, S, D) layout, viewed in place
        qh, kh, vh = _heads(q), _heads(k), _heads(v)

        def run(route=None):
            if route is None:
                return k2.flash_attention(qh, kh, vh, causal=True, window=window)
            return _heads(k2.flash_attention_bshd(_bshd(qh), _bshd(kh), _bshd(vh),
                                                  window=window, route=route))
    else:
        def run(route=None):
            if route is None:
                return _heads(mha(q, k, v, causal=True, window=window))
            return _heads(k2.flash_attention_bshd(q, k, v, window=window, route=route))
    return q, k, v, run


def phase_flash_kernel(dev: torch.device, gen: torch.Generator) -> dict:
    checks, timings = [], {}
    worst_bf16_abs = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CHECKS:
            b, sq, skv, hq, hkv, d, window, layout = case
            q, k, v, run = _flash_case(gen, dev, dtype, case)
            ref = attention_ref(_heads(q), _heads(k), _heads(v), causal=True, window=window)
            auto = k2.route(d, dtype, k2.aligned(q, k, v))
            if layout == "expand" and auto == "wgmma":   # TMA takes no stride of 0
                raise AssertionError(f"K2 {list(case)}: a broadcast head routed to wgmma")
            for forced in (None, "mma") if auto == "wgmma" else (None,):
                want = forced or auto
                k2.reset_launches()
                out = run(forced)
                again = run(forced) if want == "wgmma" else out
                torch.cuda.synchronize()
                moved = {r: n for r, n in k2.launches_by_route.items() if n}
                if moved != {want: 2 if want == "wgmma" else 1}:
                    raise AssertionError(f"K2 {list(case)} {dtype} launched {moved}, "
                                         f"meant for {want}")
                if not torch.equal(out, again):
                    raise AssertionError(f"two wgmma launches disagree at {list(case)}")
                e = _check_rows("flash-kernel", f"K2 {str(dtype)[6:]} {want:5s} {list(case)}",
                                out, ref, ROW_TOL[dtype])
                checks.append({"shape": list(case), "dtype": str(dtype), "route": want,
                               "rerun_bitwise_equal": want == "wgmma", **e})
                if dtype == torch.bfloat16:
                    worst_bf16_abs = max(worst_bf16_abs, e["max_abs_err"])
                del out, again
            del q, k, v, run, ref
            torch.cuda.empty_cache()
    for name, (b, sq, skv, hq, hkv, d, window) in FLASH_TIMED.items():
        q, k, v = _qkv(gen, dev, torch.bfloat16, b, sq, skv, hq, hkv, d)
        sdpa, backend = sdpa_yardstick(q, k, v, window)
        qh, kh, vh = _heads(q), _heads(k), _heads(v)
        g = hq // hkv
        kept = {}

        def kern():   # the path's call: mha, which takes the wgmma route
            kept["out"] = mha(q, k, v, causal=True, window=window)

        def mma():
            kept["mma"] = k2.flash_attention_bshd(q, k, v, window=window, route="mma")

        def plain():  # head by head (B = 1): one head's (S, S) scores at a time
            kept["ref"] = [attention_ref(qh[h:h + 1], kh[h // g:h // g + 1],
                                         vh[h // g:h // g + 1], causal=True, window=window)
                           for h in range(qh.shape[0])]

        k2.reset_launches()
        kern()
        if {r: n for r, n in k2.launches_by_route.items() if n} != {"wgmma": 1}:
            raise AssertionError(f"{name}: mha took {k2.launches_by_route}, not wgmma")
        t = {}
        # in turns: wgmma, mma, library, plain, library, mma, wgmma
        for key in ("ms", "mma_ms", "library_ms", "plain_ms", "library_ms", "mma_ms", "ms"):
            fn = {"ms": kern, "mma_ms": mma, "library_ms": sdpa, "plain_ms": plain}[key]
            t.setdefault(key, []).append(event_ms(fn, 1 if key == "plain_ms" else 5))
        ref = torch.cat(kept["ref"])
        shape = [b, sq, skv, hq, hkv, d, window]
        e = _check_rows("flash-kernel", f"K2 bfloat16 wgmma {name} {shape}",
                        _heads(kept["out"]), ref, ROW_TOL[torch.bfloat16])
        e_mma = _check_rows("flash-kernel", f"K2 bfloat16 mma   {name} {shape}",
                            _heads(kept["mma"]), ref, ROW_TOL[torch.bfloat16])
        worst_bf16_abs = max(worst_bf16_abs, e["max_abs_err"], e_mma["max_abs_err"])
        del kept, ref
        bms, by = flash_bound(b, sq, skv, hq, hkv, d, window)
        row = {"shape": shape, "dtype": "bfloat16", "route": "wgmma",
               **{key: min(v) for key, v in t.items()}, "runs": t, "check": e,
               "check_mma": e_mma, "bound_ms": bms, "bound_by": by,
               "exp_floor_ms": exp_floor_ms(b, sq, skv, hq, window, dev),
               "sdpa_backend": backend, "pairs_per_head": attention_pairs(sq, skv, True, window),
               **key_tiles(sq, skv, window)}
        row["bound_share"] = bms / row["ms"]
        row["tflops"] = 4.0 * d * b * hq * row["pairs_per_head"] / row["ms"] / 1e9
        timings[name] = row
        log(f"[flash-time] {name} {shape} K2 wgmma {row['ms']:.3f}ms ({row['tflops']:.0f} "
            f"TFLOP/s on unmasked pairs) mma {row['mma_ms']:.3f}ms bound {bms:.3f}ms ({by}, "
            f"{row['bound_share']:.1%}) exp floor (at {EXP2_PER_CLOCK_PER_SM} exp2/clock/SM) "
            f"{row['exp_floor_ms']:.3f}ms "
            f"sdpa[{backend}] {row['library_ms']:.3f}ms plain (head by head, full S) "
            f"{row['plain_ms']:.3f}ms; {row['tiles']} tiles of 128x128 per head, "
            f"{row['masked']} masked")
        del q, k, v, qh, kh, vh, sdpa
        torch.cuda.empty_cache()
    return {"checks": checks, "timings": timings, "worst_bf16_abs_err": worst_bf16_abs,
            "projections": projection_times(dev, gen)}


def _check_rows(phase: str, what: str, out: torch.Tensor, ref: torch.Tensor,
                tol: float) -> dict:
    """``row_err`` of a kernel's output against its plain version's, logged;
    raises unless finite and every row within ``tol``."""
    e = row_err(out, ref)
    ok = e["finite"] and e["row_rel"] < tol
    log(f"[{phase}] {what} worst row rel={e['row_rel']:.3e} (mean {e['row_rel_mean']:.3e}, "
        f"limit {tol:g}) max_abs_err={e['max_abs_err']:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} disagrees with its plain version: {e}")
    return e


def projection_times(dev: torch.device, gen: torch.Generator) -> list:
    """K1, ``torch.matmul`` and K1's plain version at the 7 projections of
    one danube layer at M = 32768 (bf16), each beside its bound; K1's
    output held against its plain version's per row."""
    cfg = get_config(PREFILL_ARCH)
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    kn = [(d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd), (d, cfg.num_kv_heads * hd),
          (cfg.num_heads * hd, d), (d, ff), (d, ff), (ff, d)]
    rows = []
    for (k, n) in kn:
        a = torch.randn(PREFILL_S, k, generator=gen, device=dev).to(torch.bfloat16)
        b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        kept = {}

        def kern():
            kept["out"] = matmul(a, b)

        def plain():
            kept["ref"] = matmul_ref(a, b)

        def wide128():
            kept["w128"] = matmul(a, b, block_m=128, block_n=128, block_k=64)

        t = {}
        before = dict(k1.launches_by_route)
        kern()
        if routes_moved(before) != {"wide": 1}:
            raise AssertionError(f"{PREFILL_S}x{k}x{n} took {routes_moved(before)}, not wide")
        for key in ("ms", "wide128_ms", "library_ms", "plain_ms", "library_ms", "wide128_ms",
                    "ms"):
            fn = {"ms": kern, "wide128_ms": wide128, "library_ms": lambda: torch.matmul(a, b),
                  "plain_ms": plain}[key]
            t.setdefault(key, []).append(event_ms(fn, 3))
        e = _check_rows("k1-prefill", f"K1 bfloat16 {PREFILL_S}x{k}x{n}", kept["out"],
                        kept["ref"], ROW_TOL[torch.bfloat16])
        e["tiles_bitwise_equal"] = bool(torch.equal(kept["out"], kept["w128"]))
        del kept
        bms, by = bound(PREFILL_S, k, n, torch.bfloat16)
        row = {"shape": [PREFILL_S, k, n], **{key: min(v) for key, v in t.items()},
               "bound_ms": bms, "bound_by": by, "check": e}
        rows.append(row)
        log(f"[k1-prefill] {PREFILL_S}x{k}x{n} K1 wide {row['ms']:.3f}ms "
            f"({2.0 * PREFILL_S * k * n / row['ms'] / 1e9:.0f} TFLOP/s; 128x128 tile "
            f"{row['wide128_ms']:.3f}ms, bitwise equal {e['tiles_bitwise_equal']}) "
            f"torch.matmul {row['library_ms']:.3f}ms "
            f"plain {row['plain_ms']:.3f}ms bound {bms:.3f}ms ({by})")
        del a, b
    torch.cuda.empty_cache()
    return rows


def phase_long_prefill(dev: torch.device, flash: dict) -> dict:
    cfg = dataclasses.replace(get_config(PREFILL_ARCH), attn_impl="flash")
    model = build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, PREFILL_S))).to(dev)
    labels = torch.cat([tokens[:, 1:], torch.full((1, 1), -100, device=dev)], dim=1)
    want = {"K2": cfg.num_layers, "K1": 7 * cfg.num_layers}
    with torch.no_grad():
        k1.reset_launches()
        k2.reset_launches()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, tokens)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got = {"K2": k2.launches, "K1": k1.launches}
        by_route = {r: v for r, v in k1.launches_by_route.items() if v}
        k2_routes = {r: v for r, v in k2.launches_by_route.items() if v}
        log(f"[long-prefill] {cfg.name} bf16 S={PREFILL_S}: forward launched K2 "
            f"{got['K2']}x, K1 {got['K1']}x (want {want}); first call {first_s:.2f}s "
            f"with set-up; K2 by route {k2_routes}, K1 by route {by_route}")
        if (got != want or by_route != {"wide": want["K1"]}
                or k2_routes != {"wgmma": want["K2"]}):
            raise AssertionError(f"launches {got} (K2 {k2_routes}, K1 {by_route}), want "
                                 f"{want}, K2 all wgmma, K1 all wide")
        if tuple(logits.shape) != (1, PREFILL_S, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"logits malformed: {tuple(logits.shape)}")
        k1.reset_launches()
        k2.reset_launches()
        loss, parts = model.loss(params, {"tokens": tokens, "labels": labels})
        loss = loss.item()
        if (k2.launches, k1.launches) != (want["K2"], want["K1"]) or not math.isfinite(loss):
            raise AssertionError(f"loss: launches K2 {k2.launches} K1 {k1.launches}, "
                                 f"loss {loss}")
        fwd_ms = event_ms(lambda: model.forward(params, tokens), 2)
        xlogits, _ = xla.forward(params, tokens)
        xloss = cross_entropy(xlogits, labels).item()
        routes = {"flash": {**row_err(logits, xlogits), "loss": loss}}
        del logits
        for what, window in PREFILL_CONTROLS.items():
            wrong = build_model(dataclasses.replace(cfg, window=window))
            clogits, _ = wrong.forward(params, tokens)
            routes[what] = {**row_err(clogits, xlogits),
                            "loss": cross_entropy(clogits, labels).item()}
            del clogits
        del xlogits
    torch.cuda.empty_cache()
    for what, e in routes.items():
        log(f"[long-prefill] {what} vs xla: logits worst row rel {e['row_rel']:.3e} "
            f"(mean {e['row_rel_mean']:.3e}), loss {e['loss']:.6f} against {xloss:.6f} "
            f"(|diff| {abs(e['loss'] - xloss):.3e}); limit {PREFILL_LOGITS_TOL:g}")
    rel = routes["flash"]["row_rel"]
    if not routes["flash"]["finite"] or rel >= PREFILL_LOGITS_TOL:
        raise AssertionError(f"flash and xla routes disagree: {routes['flash']}")
    for what in PREFILL_CONTROLS:
        if routes[what]["row_rel"] < PREFILL_LOGITS_TOL:
            raise AssertionError(f"the limit {PREFILL_LOGITS_TOL} cannot tell the xla route "
                                 f"from a wrong attention core ({what}): {routes[what]}")
    k2_ms = cfg.num_layers * flash["timings"]["danube"]["ms"]
    k2_mma_ms = cfg.num_layers * flash["timings"]["danube"]["mma_ms"]
    k1_fwd = {key: cfg.num_layers * sum(r[key] for r in flash["projections"])
              for key in ("ms", "wide128_ms", "library_ms", "plain_ms", "bound_ms")}
    k1_ms = k1_fwd["ms"]
    tok_s = PREFILL_S / (fwd_ms / 1e3)
    log(f"[long-prefill] forward device time {fwd_ms:.1f}ms ({tok_s:.0f} prefill tokens/s); "
        f"K1 {k1_ms:.1f}ms ({k1_ms / fwd_ms:.1%}), K2 {k2_ms:.1f}ms ({k2_ms / fwd_ms:.1%}), "
        f"rest {fwd_ms - k1_ms - k2_ms:.1f}ms; K2's {want['K2']} launches on the mma route "
        f"{k2_mma_ms:.1f}ms; K1's {want['K1']} products: 128x128 tile "
        f"{k1_fwd['wide128_ms']:.1f}ms, torch.matmul "
        f"{k1_fwd['library_ms']:.1f}ms, plain {k1_fwd['plain_ms']:.1f}ms, "
        f"bound {k1_fwd['bound_ms']:.1f}ms")
    del params
    torch.cuda.empty_cache()
    fp32 = fp32_check(dev)
    return {"launches": want, "k1_routes": by_route, "k2_routes": k2_routes,
            "first_forward_s": first_s, "loss": loss, "xla_loss": xloss,
            "ce": parts["ce"].item(), "logits_rel_err": rel, "routes": routes,
            "forward_ms": fwd_ms,
            "tokens_per_s": tok_s, "k1_ms": k1_ms, "k1_per_forward": k1_fwd, "k2_ms": k2_ms,
            "k2_mma_ms": k2_mma_ms,
            "fp32": fp32,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def fp32_check(dev: torch.device) -> dict:
    """2-layer full-width fp32 danube at S = 8192 (past the 4096 window):
    the flash route against the xla route on the card, within 1e-4."""
    cfg = dataclasses.replace(get_config(PREFILL_ARCH), num_layers=FP32_CHECK_LAYERS,
                              dtype="float32", attn_impl="flash")
    model = build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = model.init(torch.Generator(device=dev).manual_seed(1), dev)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, FP32_CHECK_S)))
    tokens = tokens.to(dev)
    with torch.no_grad():
        k2.reset_launches()
        flash_logits, _ = model.forward(params, tokens)
        launches = k2.launches_by_route["fma"]
        xla_logits, _ = xla.forward(params, tokens)
        e = row_err(flash_logits, xla_logits)
    rel = e["row_rel"]
    log(f"[long-prefill] {FP32_CHECK_LAYERS}-layer fp32 S={FP32_CHECK_S}: flash vs xla "
        f"logits worst row rel {rel:.3e} (mean {e['row_rel_mean']:.3e}, limit "
        f"{FP32_CHECK_TOL:g}); K2 launches {launches}")
    if launches != FP32_CHECK_LAYERS or not e["finite"] or rel >= FP32_CHECK_TOL:
        raise AssertionError(f"fp32 flash route: launches {launches}, {e}")
    del params, flash_logits, xla_logits
    torch.cuda.empty_cache()
    return {"rel_err": rel, "launches": launches}


# -- the plan engine (phases 7-9) ------------------------------------------------


def _wrong_ring_ag(x, w, axis, *, out_dtype=None, local_fn=None):
    """``ring_ag_matmul`` writing each resident chunk to the wrong row slot
    (``idx + s`` where the origin is ``idx - s``): a control."""
    local_fn = local_fn or local_matmul
    n, idx = _collectives.axis_size(axis), _collectives.axis_index(axis)
    chunk = x.shape[-2]
    out = torch.zeros(n * chunk, w.shape[-1], dtype=out_dtype, device=x.device)
    perm = [(d, (d + 1) % n) for d in range(n)]
    cur = x
    for step in range(n):
        nxt = _collectives.ppermute(cur, axis, perm) if step < n - 1 else None
        src = (idx + step) % n
        out[src * chunk:(src + 1) * chunk] = local_fn(cur, w, out_dtype=out_dtype)
        cur = nxt
    return out


def _wrong_ring_rs(y, w, axis, *, out_dtype=None, local_fn=None):
    """``ring_rs_matmul`` passing its partial sums the wrong way round the
    ring (-1 hops under the +1 chain's chunk order): a control."""
    local_fn = local_fn or local_matmul
    n, idx = _collectives.axis_size(axis), _collectives.axis_index(axis)
    partial = local_fn(y, w, out_dtype=torch.float32)
    chunk = partial.shape[-2] // n
    perm = [(d, (d - 1) % n) for d in range(n)]
    acc = None
    for step in range(n):
        c = (idx + n - 1 - step) % n
        mine = partial[c * chunk:(c + 1) * chunk]
        acc = mine if acc is None else acc + mine
        if step < n - 1:
            acc = _collectives.ppermute(acc, axis, perm)
    return acc.to(out_dtype)


def _drop_b_skew(body_fn):
    return lambda prog, *a, **kw: body_fn(dataclasses.replace(prog, skew_b=()), *a, **kw)


PLAN_CONTROLS = {
    "cannon without B skew": lambda: [
        mock.patch.object(lower_dist_mod, "torus_program_body",
                          _drop_b_skew(lower_dist_mod.torus_program_body)),
        mock.patch.object(lower_dist_mod, "torus_program_body_overlapped",
                          _drop_b_skew(lower_dist_mod.torus_program_body_overlapped))],
    "ring_ag wrong slot": lambda: [
        mock.patch.object(lower_dist_mod, "ring_ag_matmul", _wrong_ring_ag)],
    "ring_rs wrong way": lambda: [
        mock.patch.object(lower_dist_mod, "ring_rs_matmul", _wrong_ring_rs)],
}


CONTROL_OF = {"cannon": "cannon without B skew", "ring_ag": "ring_ag wrong slot",
              "ring_rs": "ring_rs wrong way"}


@contextlib.contextmanager
def wrong_program(what: str):
    """Within the scope every product of one strategy runs a wrong program
    (``PLAN_CONTROLS``); compiled lowerings are dropped on entry and exit."""
    lower_dist_mod._lower_dist_cached.cache_clear()
    try:
        with contextlib.ExitStack() as stack:
            for patch in PLAN_CONTROLS[what]():
                stack.enter_context(patch)
            yield
    finally:
        lower_dist_mod._lower_dist_cached.cache_clear()


def _nonzero(counts: dict) -> dict:
    return {r: v for r, v in counts.items() if v}


def _check_control(phase: str, what: str, e: dict, tol: float) -> None:
    log(f"[{phase}] control {what}: worst row rel={e['row_rel']:.3e} (must be >= {tol:g})")
    if e["row_rel"] < tol:
        raise AssertionError(f"the limit {tol} cannot tell a wrong program ({what}): {e}")


def account_bytes(label: str, cap, copied: dict, ranks: int) -> dict:
    """Phase 7's copied bytes through the trace of the one plan executed:
    the executed collectives must be the trace's multiset, and for ppermute
    and all_gather the bytes ``_collectives.stats`` counted must equal the
    trace's words times the element size each call carried, phase by phase
    (placement skew, movement, collection restore, gather).  psum is given
    in both conventions with no limit: the thread communicator copies
    g - 1 shards into each rank, the trace prices a ring all-reduce."""
    if len(cap.lowered_plans) != 1:
        raise AssertionError(f"{label}: {len(cap.lowered_plans)} plans lowered, want 1")
    tr = trace_plan(cap.lowered_plans[0])
    compare_records(tr.records, cap.records)
    by_phase = phase_bytes(tr, cap)
    words: dict = {}
    for r in tr.records:
        words[r.kind, r.phase] = words.get((r.kind, r.phase), 0.0) + r.words_total(tr.mesh_size)
    for kind in ("ppermute", "all_gather"):
        want = sum(v for (kd, _), v in by_phase.items() if kd == kind)
        if copied[kind]["bytes"] != want:
            raise AssertionError(f"{label}: {kind} copied {copied[kind]['bytes']} bytes, the "
                                 f"trace's words x element sizes give {want}: {by_phase}")
    psum_ring = sum(v for (kd, _), v in by_phase.items() if kd == "psum")
    return {
        "by_phase": {f"{kd} {ph}": {"mb_per_rank": v / ranks / 1e6,
                                    "words_per_rank": words[kd, ph] / ranks,
                                    "itemsize": v / words[kd, ph]}
                     for (kd, ph), v in by_phase.items() if kd != "psum"},
        "psum": {"copied_mb_per_rank": copied["psum"]["bytes"] / ranks / 1e6,
                 "ring_mb_per_rank": psum_ring / ranks / 1e6} if psum_ring else None,
    }


def phase_plan_sweep(dev: torch.device, gen: torch.Generator) -> dict:
    m, k, n = PLAN_SWEEP_SHAPE
    bf16 = torch.bfloat16
    a = torch.randn(m, k, generator=gen, device=dev).to(bf16)
    b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(bf16)
    ref = matmul(a, b)
    k1_ms = event_ms(lambda: matmul(a, b), 5)
    log(f"[plan-sweep] {m}x{k}x{n} bf16: K1 alone {k1_ms:.3f}ms "
        f"(route {k1.route(m, n, k, bf16)})")
    meshes, rows = {}, []
    for sizes, names, strategy, overlap in PLAN_SWEEP_CELLS:
        if (sizes, names) not in meshes:
            meshes[sizes, names] = Mesh(sizes, names, device=dev)
        mesh = meshes[sizes, names]
        plan = build_plan(m, n, k, mesh=mesh, strategy=strategy, overlap=overlap,
                          a_dtype=bf16, b_dtype=bf16)
        label = f"{strategy}{'+ov' if plan.overlap else ''} on {'x'.join(map(str, sizes))}"

        def planned(mesh=mesh, strategy=strategy, overlap=overlap):
            return symmetric_matmul(a, b, mesh=mesh, strategy=strategy, overlap=overlap)

        # the check run (untimed) reads each collective call's element size
        # at the seam, to account for the copied bytes through the trace
        _collectives.reset_stats()
        with k1.trace_launches() as trace, intercept() as cap:
            out = planned()
            torch.cuda.synchronize()
        copied = {kind: dict(v) for kind, v in _collectives.stats.items()}
        accounted = account_bytes(label, cap, copied, mesh.size)
        routes = {}
        for (pm, pn, pk, r) in trace:
            if r != k1.route(pm, pn, pk, bf16):
                raise AssertionError(f"{label}: a {pm}x{pk}x{pn} block product took {r}, "
                                     f"not {k1.route(pm, pn, pk, bf16)}")
            routes[r] = routes.get(r, 0) + 1
        e = _check_rows("plan-sweep", f"{label} vs K1 alone", out, ref, PLAN_ROW_TOL)
        del out
        _, in_specs, _ = lower_dist_mod.rule(plan)

        def scatter(mesh=mesh, in_specs=in_specs):
            return [lower_dist_mod.scatter(x, spec, mesh) for x, spec in zip((a, b), in_specs)]

        t = {}
        for key in ("ms", "scatter_ms", "scatter_ms", "ms"):
            t.setdefault(key, []).append(event_ms({"ms": planned, "scatter_ms": scatter}[key], 3))
        t0 = time.perf_counter()
        planned()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        moved = sum(v["bytes"] for v in copied.values()) / mesh.size
        row = {"mesh": list(sizes), "axes": list(names), "strategy": strategy,
               "overlap": plan.overlap, "grid": list(plan.grid), "pad_a": list(plan.pad_a),
               "pad_b": list(plan.pad_b), "k1_launches": len(trace), "k1_routes": routes,
               "block_shapes": sorted({tuple(x[:3]) for x in trace}), "check": e,
               "ms": min(t["ms"]), "scatter_ms": min(t["scatter_ms"]), "runs": t,
               "host_ms": host_ms, "k1_alone_ms": k1_ms,
               "cost": {"comm_bytes_per_rank": plan.cost.comm_bytes, "msgs": plan.cost.msgs,
                        "compute_s": plan.cost.compute_s, "comm_s": plan.cost.comm_s},
               "copied_bytes_per_rank": moved, "collectives": copied, "accounted": accounted}
        rows.append(row)
        log(f"[plan-sweep] {label:22s} {row['ms']:8.3f}ms (K1 alone {k1_ms:.3f}, scatter of "
            f"both operands {row['scatter_ms']:.3f}, host {host_ms:.1f}ms); K1 {len(trace)} "
            f"launches {routes}; cost words {plan.cost.comm_bytes / 1e6:.2f} MB/rank in "
            f"{plan.cost.msgs} msgs, copied {moved / 1e6:.2f} MB/rank "
            + ", ".join(f"{kd} {v['calls']}x" for kd, v in copied.items() if v["calls"]))
        parts = [f"{key} {v['mb_per_rank']:.2f} ({v['words_per_rank'] / 1e6:.2f}M words x "
                 f"{v['itemsize']:g} B)" for key, v in accounted["by_phase"].items()]
        if accounted["psum"]:
            parts.append(f"psum copied {accounted['psum']['copied_mb_per_rank']:.2f} (g - 1 "
                         f"shards into each rank) vs {accounted['psum']['ring_mb_per_rank']:.2f} "
                         f"(the trace's ring all-reduce, 2 (g - 1) shards per group), no limit")
        log(f"[plan-sweep] {'':22s} copied bytes by phase, trace words x the element size "
            f"each call carried (MB/rank): " + "; ".join(parts))
    controls = {}
    for what, (sizes, names), strategy in (
            ("cannon without B skew", ((2, 2), ("x", "y")), "cannon"),
            ("ring_ag wrong slot", ((4,), ("t",)), "ring_ag")):
        with wrong_program(what):
            out = symmetric_matmul(a, b, mesh=meshes[sizes, names], strategy=strategy)
        controls[what] = row_err(out, ref)
        _check_control("plan-sweep", what, controls[what], PLAN_ROW_TOL)
        del out
    for mesh in meshes.values():
        mesh.close()
    del a, b, ref
    torch.cuda.empty_cache()
    return {"shape": [m, k, n], "k1_alone_ms": k1_ms, "cells": rows, "controls": controls,
            "k1_launches": sum(r["k1_launches"] for r in rows)}


def phase_planned_serve(dev: torch.device) -> dict:
    """Phase 8: phase 4's workload through ``Server(mesh=2x2)``, captured
    per bucket (the rank threads launch on the capturing stream) and
    replayed, against the eager planned path on the same bucket-padded
    batch: identical tokens; a failed capture fails the run."""
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    mesh = Mesh(*PLANNED_MESH, device=dev)
    sc = ServeConfig(max_new_tokens=SERVE_NEW, max_seq=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in (5, 9, 12, 16)]
    local = Server(model, params, sc, buckets=SERVE_BUCKETS)
    local.warmup()
    local_tokens = local.generate(prompts).new_tokens
    products = 7 * cfg.num_layers * SERVE_NEW
    k1.reset_launches()
    server = Server(model, params, sc, mesh=mesh, buckets=SERVE_BUCKETS)
    warm = server.warmup()
    path = {"launches": k1.launches, "routes": _nonzero(k1.launches_by_route)}
    log(f"[planned-serve] mesh {dict(mesh.shape)} warmup " + ", ".join(
        f"{k} {v['warm_s']:.2f}s + {v['graphs']} graphs captured in {v['capture_s']:.2f}s"
        for k, v in warm.items()) + f"; K1 counted in warmup and captures {path['routes']}")
    runs = served_runs(server, prompts, 2, "planned-serve", cfg.vocab_size)
    path_counts(path, runs)
    for r in runs:
        if (not r["graphs"] or r["counted"] or sum(r["strategies"].values()) != products
                or set(r["routes"]) != {"thin"}):
            raise AssertionError(f"a captured planned run served {r['strategies']} products "
                                 f"({r['routes']}, counted from Python {r['counted']}), want "
                                 f"{products} by graph replays, all K1 launches thin")
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError("two planned generate runs disagree")
    eager = eager_runs(model, params, sc, prompts, 1, "planned-serve", mesh=mesh)
    for r in eager:
        if (r["graphs"] or sum(r["strategies"].values()) != products
                or set(r["routes"]) != {"thin"} or r["counted"] != r["routes"]):
            raise AssertionError(f"an eager planned run served {r['strategies']} ({r['routes']})")
        if r["tokens"] != runs[0]["tokens"]:
            raise AssertionError("the captured planned steps' tokens differ from the eager "
                                 "planned path's")
    agree = sum(x == y for p, r in zip(runs[0]["tokens"], local_tokens) for x, y in zip(p, r))
    path["report"] = server.cache_report()
    log(f"[planned-serve] tokens bitwise equal across the two captured runs and the eager "
        f"planned run; {agree} of {len(prompts) * SERVE_NEW} agree with mesh=None (printed, "
        f"not held); graphs {path['report']['graphs']}")
    summary = {name: {key: float(np.median([r[key] for r in rs]))
                      for key in ("ttft_ms", "p50_ms", "p99_ms", "tokens_per_s")}
               for name, rs in (("graphs", runs), ("eager", eager))}
    # the planned prefill's last-token logits against mesh=None's
    batch, lens = batch_requests(prompts, pad_to=SERVE_BUCKETS[0][1])
    tokens = torch.as_tensor(batch, dtype=torch.int64, device=dev)
    offsets = torch.as_tensor(batch.shape[1] - lens, dtype=torch.int64, device=dev)

    def prefill():
        return model.prefill(params, model.init_cache(len(prompts), 64, dev), tokens, offsets)[0]

    with torch.no_grad():
        ref = prefill()
        lower_dist_mod.reset_executions()
        with planned_matmuls(mesh):
            got = prefill()
        prefill_plans = lower_dist_mod.executions_snapshot()
        e = _check_rows("planned-serve", f"planned prefill logits ({prefill_plans}) vs "
                        f"mesh=None", got, ref, PLANNED_LOGITS_TOL)
        # the wrong program replaces the strategy the prefill ran most
        wrong = "ring_rs wrong way" if prefill_plans.get("ring_rs+ov", 0) >= \
            prefill_plans.get("ring_ag+ov", 0) else "ring_ag wrong slot"
        with wrong_program(wrong), planned_matmuls(mesh):
            control = row_err(prefill(), ref)
        _check_control("planned-serve", wrong, control, PLANNED_LOGITS_TOL)
        step_ms = planned_step_ms(model, params, mesh, dev)
    log(f"[planned-serve] decode step device time (CUDA events, eager, bucket 4x16): planned "
        f"{step_ms['planned_ms']:.3f}ms, mesh=None {step_ms['local_ms']:.3f}ms; CUDA graph of "
        f"a planned decode step replays in {step_ms['graph']['replay_ms']:.3f}ms")
    mesh.close()
    del server, local, params
    torch.cuda.empty_cache()
    return {"mesh": dict(mesh.shape), "warmup": warm, "runs": runs, "eager_runs": eager,
            "summary": summary, "path": path, "agree_with_local": agree,
            "local_tokens": local_tokens, "prefill_logits": e, "prefill_plans": prefill_plans,
            "control": {wrong: control},
            "step": step_ms}


def planned_step_ms(model, params, mesh, dev: torch.device) -> dict:
    """One decode step at the (4, 16) bucket, eager, by CUDA events:
    mesh=None and planned in turns; then the planned step captured in a
    CUDA graph (its rank threads launch on the capturing stream) and one
    replay timed."""
    batch, seq = SERVE_BUCKETS[0]
    cache = model.init_cache(batch, 64, dev)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(1, model.cfg.vocab_size, size=(batch, 1))).to(dev)
    offsets = torch.zeros(batch, dtype=torch.int64, device=dev)

    def local():
        return model.decode_step(params, cache, tokens, seq, offsets)

    def planned():
        with planned_matmuls(mesh):
            return model.decode_step(params, cache, tokens, seq, offsets)

    t = {}
    for key in ("local_ms", "planned_ms", "planned_ms", "local_ms"):
        t.setdefault(key, []).append(event_ms({"local_ms": local, "planned_ms": planned}[key], 3))
    out = {key: min(v) for key, v in t.items()}
    out["runs"] = t
    # a failed capture raises here and fails the run
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        planned()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    out["graph"] = {"captured": True, "replay_ms": start.elapsed_time(end)}
    del graph
    # the card is still sound after the capture
    x = torch.randn(64, 256, device=dev).to(torch.bfloat16)
    w = torch.randn(256, 128, device=dev).to(torch.bfloat16)
    if row_err(matmul(x, w), matmul_ref(x, w))["row_rel"] >= ROW_TOL[torch.bfloat16]:
        raise AssertionError("K1 disagrees with its plain version after the graph capture")
    torch.cuda.synchronize()
    return out


def phase_planned_prefill(dev: torch.device) -> dict:
    cfg = dataclasses.replace(get_config(PREFILL_ARCH), attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, PREFILL_S))).to(dev)
    mesh = Mesh(*PLANNED_MESH, device=dev)
    products = 7 * cfg.num_layers

    def planned():
        with planned_matmuls(mesh):
            return model.forward(params, tokens)[0]

    with torch.no_grad():
        ref, _ = model.forward(params, tokens)
        lower_dist_mod.reset_executions()
        k1.reset_launches()
        k2.reset_launches()
        t0 = time.perf_counter()
        logits = planned()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        plans = lower_dist_mod.executions_snapshot()
        k1_routes, k2_routes = _nonzero(k1.launches_by_route), _nonzero(k2.launches_by_route)
        want_k1 = sum(v * LAUNCHES_PER_PRODUCT_2X2.get(s, LAUNCHES_PER_PRODUCT_2X2.get(
            s.split("+")[0], 0)) for s, v in plans.items())
        log(f"[planned-prefill] {cfg.name} bf16 S={PREFILL_S} on mesh {dict(mesh.shape)}: "
            f"products {plans}; K1 {k1.launches}x {k1_routes} (want {want_k1}), K2 "
            f"{k2.launches}x {k2_routes}; first call {first_s:.2f}s")
        if (sum(plans.values()) != products or k1.launches != want_k1
                or set(k1_routes) != {"wide"} or k2_routes != {"wgmma": cfg.num_layers}):
            raise AssertionError(f"planned forward: products {plans} (want {products}), K1 "
                                 f"{k1_routes} (want {want_k1} wide), K2 {k2_routes}")
        if tuple(logits.shape) != (1, PREFILL_S, cfg.vocab_size):
            raise AssertionError(f"logits malformed: {tuple(logits.shape)}")
        e = _check_rows("planned-prefill", "planned logits vs the unplanned forward", logits,
                        ref, PREFILL_LOGITS_TOL)
        del logits
        controls = {}
        # a wrong program for each strategy the forward ran (at S = 32768 on
        # 2x2: Cannon and ring_rs)
        for what in [CONTROL_OF[s.split("+")[0]] for s in plans if s.split("+")[0] in CONTROL_OF]:
            with wrong_program(what):
                controls[what] = row_err(planned(), ref)
            _check_control("planned-prefill", what, controls[what], PREFILL_LOGITS_TOL)
        if not controls:
            raise AssertionError(f"no wrong program covers the strategies taken: {plans}")
        del ref
        torch.cuda.empty_cache()

        def local():
            return model.forward(params, tokens)[0]

        t = {}
        for key in ("local_ms", "planned_ms", "planned_ms", "local_ms"):
            t.setdefault(key, []).append(event_ms({"local_ms": local, "planned_ms": planned}[key],
                                                  1))
    out = {key: min(v) for key, v in t.items()}
    log(f"[planned-prefill] forward device time (CUDA events): planned {out['planned_ms']:.1f}ms "
        f"({PREFILL_S / out['planned_ms'] * 1e3:.0f} prefill tokens/s), unplanned "
        f"{out['local_ms']:.1f}ms ({PREFILL_S / out['local_ms'] * 1e3:.0f}); runs {t}")
    mesh.close()
    del params
    torch.cuda.empty_cache()
    return {"mesh": dict(mesh.shape), "plans": plans, "k1_launches": want_k1,
            "k1_routes": k1_routes, "k2_routes": k2_routes, "first_forward_s": first_s,
            "logits": e, "controls": controls, **out, "runs": t,
            "tokens_per_s": PREFILL_S / out["planned_ms"] * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


# -- conformance (phase 10) ---------------------------------------------------------


def _plan_label(plan) -> str:
    return (f"{plan.strategy}{'+ov' if plan.overlap else ''} on "
            f"{'x'.join(str(plan.mesh.shape[a]) for a in plan.mesh.axis_names)} "
            f"({plan.m}x{plan.k}x{plan.n} {str(plan.out_dtype).replace('torch.', '')})")


def _expect_caught(what: str, leg: str, fn) -> str:
    """Run a control that must fail conformance at ``leg``."""
    try:
        fn()
    except ConformanceError as e:
        if not str(e).startswith(f"[{leg}]"):
            raise AssertionError(f"{what} was caught by another leg than {leg}: {e}") from e
        log(f"[conformance] control {what}: caught, {str(e)[:160]}")
        return str(e)
    raise AssertionError(f"{what} was not caught at the {leg} leg")


def live_decode_step(dev: torch.device, mesh) -> dict:
    """One planned decode step of phase 8's workload (full Llama-3.2-1B,
    bucket 4x16) under ``intercept()``."""
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch, seq = SERVE_BUCKETS[0]
    cache = model.init_cache(batch, 64, dev)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, size=(batch, 1))).to(dev)
    offsets = torch.zeros(batch, dtype=torch.int64, device=dev)
    with torch.no_grad(), intercept() as cap, planned_matmuls(mesh):
        logits = model.decode_step(params, cache, tokens, seq, offsets)[0]
        torch.cuda.synchronize()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("the planned decode step's logits are not finite")
    del params, cache, logits
    return {"plans": len(cap.lowered_plans), "records_by_kind": check_capture(cap),
            "products": 7 * cfg.num_layers}


def live_prefill(dev: torch.device, mesh) -> dict:
    """One planned danube forward of phase 9's workload (S = 32768, 2x2)
    under ``intercept()``."""
    cfg = dataclasses.replace(get_config(PREFILL_ARCH), attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, PREFILL_S))).to(dev)
    with torch.no_grad(), intercept() as cap, planned_matmuls(mesh):
        logits = model.forward(params, tokens)[0]
        torch.cuda.synchronize()
    if tuple(logits.shape) != (1, PREFILL_S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"the planned forward's logits are malformed: {tuple(logits.shape)}")
    del params, logits
    torch.cuda.empty_cache()
    return {"plans": len(cap.lowered_plans), "records_by_kind": check_capture(cap),
            "products": 7 * cfg.num_layers}


def phase_conformance(dev: torch.device) -> dict:
    """Phase 10: the port's conformance checker over the executed schedules
    (``repro_torch.verify``); every leg fatal."""
    # the plans phases 7-9 built, before the matrix adds its own
    built = [p for p in plan_cache.plans() if isinstance(p.mesh, Mesh) and p.mesh.size > 1]
    k1.reset_launches()
    seconds, out = {}, {}

    t0 = time.perf_counter()
    rows = run_matrix(measure=True, device=dev)
    seconds["matrix"] = time.perf_counter() - t0
    bad = [r for r in rows if not r["ok"]]
    per_strategy: dict = {}
    for r in rows:
        per_strategy[r["strategy"]] = per_strategy.get(r["strategy"], 0) + 1
    log(f"[conformance] run_matrix on {torch.cuda.get_device_name(0)}: {len(rows)} rows "
        f"(every catalog cell up to 16 ranks x {len(CASES)} cases x fp32, bf16 x staged, "
        f"overlapped) by strategy {per_strategy}, {len(rows) - len(bad)} ok, "
        f"{seconds['matrix']:.1f}s")
    want = sum(len(CASES) * 2 * len(_overlap_modes(st, shape))
               for st, shape, _ in matrix_cells(16))
    if bad or len(rows) != want:
        raise AssertionError(f"{len(bad)} of {len(rows)} matrix rows fail (want {want} "
                             f"rows): {bad[:5]}")
    out["matrix"] = {"rows": len(rows), "by_strategy": per_strategy}

    t0 = time.perf_counter()
    origins = {"sweep": 0, "llama": 0, "danube": 0}
    checked = []
    for plan in built:
        origin = ("sweep" if (plan.m, plan.k, plan.n) == PLAN_SWEEP_SHAPE
                  else "danube" if plan.m == PREFILL_S else "llama")
        origins[origin] += 1
        rep = check(plan, measure=True)
        checked.append({"plan": _plan_label(plan), "origin": origin,
                        "words_per_node": rep.words_per_node,
                        "peak_node_words": rep.peak_node_words, "itt_bound": rep.itt_bound})
    seconds["full_width"] = time.perf_counter() - t0
    log(f"[conformance] full width: {len(checked)} plans of phases 7-9 pass "
        f"check(measure=True) ({origins}), {seconds['full_width']:.1f}s")
    swept = {(tuple(p.mesh.shape.items()), p.strategy) for p in built
             if (p.m, p.k, p.n) == PLAN_SWEEP_SHAPE}
    missing = [c for c in PLAN_SWEEP_CELLS if (tuple(zip(c[1], c[0])), c[2]) not in swept]
    if missing or not origins["llama"] or origins["danube"] != 4:
        raise AssertionError(f"phases 7-9 should have left every sweep cell's plan (missing "
                             f"{missing}), Llama's and danube's 4 in the plan cache: {origins}")
    out["full_width"] = {"plans": checked, "by_origin": origins}

    t0 = time.perf_counter()
    mesh = Mesh(*PLANNED_MESH, device=dev)
    live = {"decode_step": live_decode_step(dev, mesh), "prefill": live_prefill(dev, mesh)}
    mesh.close()
    seconds["live"] = time.perf_counter() - t0
    for what, r in live.items():
        log(f"[conformance] live {what}: {r['plans']} planned products, executed records per "
            f"kind {r['records_by_kind']} = the summed traces")
        if r["plans"] != r["products"]:
            raise AssertionError(f"live {what}: {r['plans']} products, want {r['products']}")
    out["live"] = live

    t0 = time.perf_counter()
    cannon = next(p for p in built if p.strategy == "cannon" and not p.overlap
                  and (p.m, p.k, p.n) == PLAN_SWEEP_SHAPE)
    pairs = list(cannon.torus.step_a)
    pairs[0], pairs[1] = (pairs[0][0], pairs[1][1]), (pairs[1][0], pairs[0][1])
    mutated = dataclasses.replace(cannon, torus=dataclasses.replace(cannon.torus,
                                                                    step_a=tuple(pairs)))
    controls = {"wrong permutation, static": _expect_caught(
        "wrong permutation (static)", "structure", lambda: check(mutated))}
    executed = measure_plan(mutated)
    controls["wrong permutation, executed"] = _expect_caught(
        "wrong permutation (executed on the card)", "interceptor",
        lambda: compare_records(trace_plan(cannon).records, executed.records))

    def no_b_skew():
        with wrong_program("cannon without B skew"):
            check(cannon, measure=True)

    controls["cannon without B skew"] = _expect_caught("cannon without B skew", "interceptor",
                                                       no_b_skew)
    seconds["controls"] = time.perf_counter() - t0
    for m in {id(p.mesh): p.mesh for p in built}.values():   # measuring restarted them
        m.close()
    routes = _nonzero(k1.launches_by_route)
    log(f"[conformance] K1 launches in this phase: {k1.launches} {routes}; seconds per leg "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    torch.cuda.empty_cache()
    return {**out, "controls": controls, "seconds": seconds, "k1_launches": k1.launches,
            "k1_routes": routes}


# -- calibrate + tune (phase 11) ------------------------------------------------------


def llama_tune_shapes(mesh) -> tuple:
    """The (m, n, k) products K1 runs serving Llama-3.2-1B in the serving
    buckets: unplanned (decode M = batch, prefill M = batch x seq, each of
    the 4 distinct projections) and each planned product's per-rank block
    product on ``mesh`` (``plan.ir._local_kernel_shape``)."""
    unplanned, per_rank = [], {}
    for b, seq in SERVE_BUCKETS:
        for m in (b, b * seq):
            for (k, n) in sorted(set(LAYER_KN)):
                unplanned.append((m, n, k))
                plan = build_plan(m, n, k, mesh=mesh, a_dtype=torch.bfloat16,
                                  b_dtype=torch.bfloat16)
                per_rank[(m, n, k)] = (plan.strategy + ("+ov" if plan.overlap else ""),
                                       plan_ir._local_kernel_shape(plan.strategy, plan.grid,
                                                                   m, n, k, mesh.size))
    return unplanned, per_rank


def phase_calibrate(dev: torch.device) -> dict:
    """Phase 11: ``perf_probe`` on a 2x2 rank-thread mesh (links, K1's
    peak) with the K1 autotune over Llama's serving shapes, the profile and
    table saved; each winner beside K1's default blocks; planned serving
    with the tuner; ``build_plan(profile=)`` against the TPU constants."""
    os.makedirs(OUT_DIR, exist_ok=True)
    name = torch.cuda.get_device_name(dev)
    mesh = Mesh(*PLANNED_MESH, device=dev)
    unplanned, per_rank = llama_tune_shapes(mesh)
    shapes = sorted(set(unplanned) | {v[1] for v in per_rank.values()})
    prof_path = os.path.join(OUT_DIR, "machine_profile.json")
    table_path = os.path.join(OUT_DIR, "tuning_table.json")
    k1.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # it prints the whole profile
        perf_probe.main(["--device", "cuda", "--mesh-shape", "2x2",
                         "--reps", str(CALIBRATE_REPS), "--profile-out", prof_path,
                         "--tune", "--tune-shapes", ",".join(f"{m}x{n}x{k}" for m, n, k in shapes),
                         "--tune-reps", str(TUNE_REPS), "--tune-candidates", "0",
                         "--tune-dtype", "bfloat16", "--tune-out", table_path])
    probe_s = time.perf_counter() - t0
    profile = obs.load_profile(prof_path)
    table = load_table(table_path)
    if (profile.platform != "cuda" or profile.device_kind != name
            or "rank threads" not in profile.link_medium or table.device_kind != name
            or profile.tuning is None or profile.tuning.entries != table.entries):
        raise AssertionError(f"the profile or table is not the card's: {profile.to_json()}")
    links = {n: {"alpha_us": p.alpha_s * 1e6, "bw_gb_s": p.bw_bytes_per_s / 1e9}
             for n, p in profile.links}
    peak_n = calibrate.PEAK_N["cuda"]
    log(f"[calibrate] perf_probe on {name}, mesh 2x2 ({profile.link_medium}), "
        f"{probe_s:.1f}s: peak {profile.peak_flops / 1e12:.1f} TFLOP/s (K1 at {peak_n}^3 bf16, "
        f"{k1.route(peak_n, peak_n, peak_n, torch.bfloat16)} route); "
        f"links " + ", ".join(f"{n} alpha {v['alpha_us']:.1f}us bw {v['bw_gb_s']:.1f}GB/s"
                               for n, v in links.items()))
    winners = []
    for key, e in table.entries:
        dtype, bm, bn, bk = key
        cand = (e.block_m, e.block_n, e.block_k, e.order)
        default = default_candidate(bm, bn, bk, dtype)
        default_s = time_candidate(bm, bn, bk, dtype, default, reps=TUNE_REPS, device=dev)
        row = {"bucket": [bm, bn, bk], "dtype": dtype, "blocks": list(cand[:3]),
               "order": e.order, "route": candidate_route(cand, dtype), "us": e.seconds * 1e6,
               "default_blocks": list(default[:3]),
               "default_route": candidate_route(default, dtype), "default_us": default_s * 1e6}
        winners.append(row)
        log(f"[tune] bucket {bm}x{bn}x{bk} {dtype}: {e.label} ({row['route']}) "
            f"{row['us']:.2f}us; default {'x'.join(map(str, default[:3]))}/zorder "
            f"({row['default_route']}) {row['default_us']:.2f}us")
    # K1 launched by the probe's peak, the search and the default timings
    tune_launches = {"launches": k1.launches, "routes": _nonzero(k1.launches_by_route)}
    tuned_serve = tuned_planned_serve(dev, mesh, table)
    picks = strategy_picks(mesh, profile)
    mesh.close()
    torch.cuda.empty_cache()
    return {"profile": profile.to_json(), "links": links, "probe_s": probe_s,
            "shapes": {"unplanned": unplanned,
                       "per_rank": {"x".join(map(str, k)): v for k, v in per_rank.items()}},
            "winners": winners, "tuned_serve": tuned_serve, "strategy_picks": picks,
            "k1_launches": tune_launches["launches"], "k1_routes": tune_launches["routes"],
            "profile_path": prof_path, "table_path": table_path}


@contextlib.contextmanager
def k1_calls():
    """Within the scope, list each K1 call ``ops.matmul`` makes (from every
    rank thread) as (m, n, k, blocks, order, dtype, out dtype)."""
    ops = importlib.import_module("repro_torch.kernels.matmul.ops")
    real = ops._run
    calls = []

    def recording(a, b, blocks, order, out_dtype):
        calls.append((a.shape[0], b.shape[1], a.shape[1], tuple(blocks), order, a.dtype,
                      out_dtype))
        return real(a, b, blocks, order, out_dtype)

    with mock.patch.object(ops, "_run", recording):
        yield calls


def check_tuned_calls(calls: list, tuned_plans: list, dev: torch.device) -> dict:
    """Every distinct K1 call of a tuned run: its blocks and order must be
    a tuned plan's, and K1 with them at the call's own shape and types must
    agree with its plain version within ``ROW_TOL`` on fresh seeded
    operands."""
    tilings = {((p.tiling.block_m, p.tiling.block_n, p.tiling.block_k), p.tiling.order)
               for p in tuned_plans}
    gen = torch.Generator(device=dev).manual_seed(5)
    worst, rows = 0.0, []
    for (m, n, k, blocks, order, dt, out_dtype), count in sorted(Counter(calls).items(), key=str):
        if (blocks, order) not in tilings:
            raise AssertionError(f"a tuned run called K1 at {m}x{n}x{k} with {blocks}/{order}, "
                                 f"which no tuned plan names ({sorted(tilings)})")
        a = torch.randn((m, k), generator=gen, device=dev).to(dt)
        b = torch.randn((k, n), generator=gen, device=dev).to(dt)
        got = matmul(a, b, block_m=blocks[0], block_n=blocks[1], block_k=blocks[2],
                     order=order, out_dtype=out_dtype)
        e = row_err(got, matmul_ref(a, b, out_dtype))
        if not e["row_rel"] < min(ROW_TOL[dt], ROW_TOL[out_dtype]):
            raise AssertionError(f"K1 with tuned {blocks}/{order} at {m}x{n}x{k} disagrees with "
                                 f"its plain version: {e}")
        worst = max(worst, e["row_rel"])
        rows.append({"shape": [m, n, k], "blocks": list(blocks), "order": order,
                     "route": k1.ROUTE_OF[dt, blocks],
                     "out_dtype": str(out_dtype).replace("torch.", ""), "calls": count,
                     "row_rel": e["row_rel"]})
    return {"distinct": rows, "calls": len(calls), "worst_row_rel": worst}


def forced_logits(model, params, dev, full: list, sp: int, offsets, mesh, tuning) -> list:
    """The prefill's and every decode step's logits of the planned path
    (``tuning=`` or not) fed the token array ``full`` (B, S + new)."""
    full = torch.as_tensor(full, dtype=torch.int64, device=dev)
    cache = model.init_cache(full.shape[0], 64, dev)
    with torch.no_grad(), planned_scope(mesh, None, tuning):
        out = [model.prefill(params, cache, full[:, :sp], offsets)[0]]
        for t in range(sp, full.shape[1] - 1):
            pos = torch.full((), t, dtype=torch.int64, device=dev)
            out.append(model.decode_step(params, cache, full[:, t:t + 1], pos, offsets)[0])
    return out


def tuned_planned_serve(dev: torch.device, mesh, table) -> dict:
    """Phase 4's workload through ``Server(mesh=2x2, tuning=tuner)``:
    captured, identical tokens across two runs and to the eager tuned
    planned path (bitwise); every K1 call of that eager run held to the
    plain version at its shape, blocks and order; the tuner's serve
    window; and the tuned prefill and decode-step logits, fed the same
    tokens, against the untuned planned ones."""
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    sc = ServeConfig(max_new_tokens=SERVE_NEW, max_seq=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in (5, 9, 12, 16)]
    tuner = Tuner(table=table, reps=TUNE_REPS, device=dev)
    server = Server(model, params, sc, mesh=mesh, tuning=tuner, buckets=SERVE_BUCKETS)
    warm = server.warmup()
    runs = served_runs(server, prompts, 2, "tuned-serve", cfg.vocab_size)
    if runs[0]["tokens"] != runs[1]["tokens"] or not all(r["graphs"] for r in runs):
        raise AssertionError("two tuned planned runs disagree (or were not replayed)")
    tuned_plans = [p for p in plan_cache.plans() if p.mesh is mesh and p.tiling.tuned]
    if not tuned_plans:
        raise AssertionError("no plan on the mesh took tuned blocks")
    tuned_logits: list = []
    with k1_calls() as calls:
        eager = eager_runs(model, params, sc, prompts, 1, "tuned-serve", mesh=mesh,
                           tuning=tuner, logits=tuned_logits)
    if eager[0]["tokens"] != runs[0]["tokens"]:
        raise AssertionError("the captured tuned planned steps' tokens differ from the eager "
                             "tuned planned path's")
    checked = check_tuned_calls(calls, tuned_plans, dev)
    log(f"[tuned-serve] tokens bitwise equal across the two captured runs and the eager tuned "
        f"run; its {checked['calls']} K1 calls, {len(checked['distinct'])} distinct (shape, "
        f"blocks, order, out type), each a tuned plan's and within ROW_TOL of the plain "
        f"version at its own shape (worst row rel {checked['worst_row_rel']:.3e}): " + ", ".join(
            f"{'x'.join(map(str, r['shape']))} {'x'.join(map(str, r['blocks']))}/{r['order']} "
            f"{r['route']} x{r['calls']}" for r in checked["distinct"]))
    # the untuned planned path fed the eager tuned run's tokens, step by step
    full = eager[0]["full"]
    sp = len(full[0]) - SERVE_NEW
    batch, lens = batch_requests(list(prompts) + [[DUMMY_TOKEN]] * (len(full) - len(prompts)),
                                 PAD_ID, pad_to=sp)
    offsets = torch.as_tensor(sp - lens, dtype=torch.int64, device=dev)
    untuned = forced_logits(model, params, dev, full, sp, offsets, mesh, None)
    if not len(untuned) == len(tuned_logits) == SERVE_NEW:
        raise AssertionError(f"{len(untuned)} untuned and {len(tuned_logits)} tuned steps")
    steps = []
    for i, (got, ref) in enumerate(zip(tuned_logits, untuned)):
        e = row_err(got, ref)
        steps.append(e)
        if not (e["finite"] and e["row_rel"] < PLANNED_LOGITS_TOL):
            raise AssertionError(f"tuned planned {'prefill' if i == 0 else f'decode step {i}'} "
                                 f"logits vs untuned planned: {e} (limit {PLANNED_LOGITS_TOL})")
    log(f"[tuned-serve] tuned vs untuned planned logits fed the same tokens, prefill + "
        f"{len(steps) - 1} decode steps: worst row rel {max(e['row_rel'] for e in steps):.3e} "
        f"(prefill {steps[0]['row_rel']:.3e}; limit {PLANNED_LOGITS_TOL:g})")
    rep = server.cache_report()["tuning"]
    moved = [{"bucket": list(key[1:]), "blocks": [e.block_m, e.block_n, e.block_k],
              "order": e.order, "route": candidate_route((e.block_m, e.block_n, e.block_k),
                                                         key[0]), "us": e.seconds * 1e6}
             for key, e in tuner.table().entries
             if (e.block_m, e.block_n, e.block_k, e.order) != default_candidate(*key[1:], key[0])]
    log(f"[tuned-serve] the tuner's {rep['entries']} buckets, {len(moved)} away from K1's "
        f"default blocks: " + ", ".join(
            f"{'x'.join(map(str, r['bucket']))} {'x'.join(map(str, r['blocks']))}/{r['order']} "
            f"({r['route']}) {r['us']:.2f}us" for r in moved))
    log(f"[tuned-serve] {len(tuned_plans)} tuned plans on the mesh "
        f"({sorted({p.tiling.block_m for p in tuned_plans})} block_m, orders "
        f"{sorted({p.tiling.order for p in tuned_plans})}); tuner {rep}")
    del server, params, tuned_logits, untuned
    torch.cuda.empty_cache()
    return {"warmup": warm, "runs": runs, "eager_runs": eager, "k1_calls": checked,
            "logits_per_step": steps, "tuning": rep, "tuned_plans": len(tuned_plans),
            "away_from_default": moved,
            "summary": {key: float(np.median([r[key] for r in runs]))
                        for key in ("ttft_ms", "p50_ms", "p99_ms", "tokens_per_s")}}


def strategy_picks(mesh, profile) -> list:
    """``build_plan``'s strategy at Llama's serving shapes and danube's long
    prefill on 2x2: the reference's TPU constants beside the card's
    profile (links and K1's peak measured here, its tuning table)."""
    rows = []
    for arch, kns, ms in (("llama3.2-1b", sorted(set(LAYER_KN)), (4, 64)),
                          (PREFILL_ARCH, DANUBE_KN, (PREFILL_S,))):
        for m in ms:
            for (k, n) in kns:
                kw = dict(mesh=mesh, a_dtype=torch.bfloat16, b_dtype=torch.bfloat16,
                          use_cache=False)
                picks = {}
                for label, prof in (("tpu_constants", None), ("h100_profile", profile)):
                    p = build_plan(m, n, k, profile=prof, **kw)
                    picks[label] = p.strategy + ("+ov" if p.overlap else "")
                rows.append({"arch": arch, "shape": [m, k, n], **picks})
    for r in rows:
        log(f"[calibrate] {r['arch']} {r['shape'][0]}x{r['shape'][1]}x{r['shape'][2]} on 2x2: "
            f"TPU constants {r['tpu_constants']}, H100 profile {r['h100_profile']}")
    return rows


# -- obs + drift (phase 12) -----------------------------------------------------------


def phase_obs_drift(dev: torch.device, profile_path: str) -> dict:
    """Phase 12: ``check_drift`` on the card (every drift cell's obs,
    interceptor and trace multisets equal; phase 11's profile as the
    stored one), then one ``generate`` of phase 4's workload and one
    planned product per drift cell under ``obs.observe()``, written out as
    a Perfetto trace and a metrics snapshot."""
    t0 = time.perf_counter()
    drift = check_drift(profile_path=profile_path, device=dev)
    drift_s = time.perf_counter() - t0
    for c in drift["cells"]:
        log(f"[drift] {c['strategy']} on {c['mesh']}: {c['collectives']} collectives, "
            f"obs == interceptor == trace: {c['ok']} {c['error']}")
    for r in drift["ranking"]:
        log(f"[drift] ranking {r['shape']}: stored {r['stored_top']}, fresh {r['fresh_top']}, "
            f"margin {r['margin']:.3f}, flipped {r['flipped']}")
    for r in drift["tuning"]:
        log(f"[drift] tuning {r['bucket']} {r['dtype']}: stored {r['stored']}, fresh "
            f"{r['fresh']}, margin {r['margin']:.3f}, flipped {r['flipped']}")
    if len(drift["cells"]) != len(DRIFT_CELLS) or not drift["ok"]:
        raise AssertionError(f"check_drift on the card is not ok: {drift['cells']} "
                             f"{drift['ranking']} {drift['tuning']}")
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    sc = ServeConfig(max_new_tokens=SERVE_NEW, max_seq=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in (5, 9, 12, 16)]
    m, k, n = OBS_PRODUCT
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
    ref = matmul(a, b)
    products = {}
    obs.reset_metrics()
    with torch.no_grad(), obs.observe() as rec:
        server = Server(model, params, sc, buckets=SERVE_BUCKETS)
        server.warmup()
        res = server.generate(prompts)
        for strategy, shape, names in DRIFT_CELLS:
            mesh = Mesh(shape, names, device=dev)
            plan = build_plan(m, n, k, mesh=mesh, strategy=strategy, a_dtype=torch.bfloat16,
                              b_dtype=torch.bfloat16)
            out = execute_plan(plan, a, b)
            torch.cuda.synchronize()
            mesh.close()
            got = obs.collective_multiset(rec, strategy=strategy)
            want = Counter(r.key for r in trace_plan(plan).records)
            e = row_err(out, ref)
            products[strategy] = {"mesh": list(shape), "collectives": sum(got.values()),
                                  "row_rel": e["row_rel"], "obs_equals_trace": got == want}
            if got != want or e["row_rel"] >= PLAN_ROW_TOL:
                raise AssertionError(f"{strategy} under tracing: obs multiset {sorted(got)[:3]} "
                                     f"vs trace {sorted(want)[:3]}, row rel {e['row_rel']}")
    trace_path = obs.write_trace(os.path.join(OUT_DIR, "obs_trace.json"), rec)
    metrics_path = obs.write_metrics(os.path.join(OUT_DIR, "obs_metrics.json"), rec)
    snap = obs.metrics_snapshot(rec)
    spans = snap["spans"]
    met = snap["metrics"]
    log(f"[obs] traced: generate bucket {res.bucket} ({'graph replays' if res.graphs else 'eager'}) "
        f"and {len(products)} planned products {products}; spans {spans}; "
        f"serve.ttft_us {met.get('serve.ttft_us')}; kernel.matmul.us "
        f"{met.get('kernel.matmul.us')}; wrote {trace_path}, {metrics_path}")
    want_spans = ("serve.warmup", "serve.prefill", "serve.decode_step", "kernel.matmul",
                  "plan.build", "plan.execute", "dist.prefetch")
    missing = [s for s in want_spans if not spans.get(s)]
    if missing or not met.get("serve.requests{bucket=4x16}"):
        raise AssertionError(f"the traced run lacks spans {missing} or serve counters: {met}")
    del server, params
    torch.cuda.empty_cache()
    return {"drift": drift, "drift_s": drift_s, "products": products, "spans": spans,
            "metrics": met, "trace": os.path.relpath(trace_path, ROOT),
            "metrics_file": os.path.relpath(metrics_path, ROOT)}


# -- torch.profiler (phase 13) -----------------------------------------------------------

K1_KERNELS = ("zorder_matmul",)
K2_KERNELS = ("flash_wgmma_kernel", "flash_bf16_kernel", "flash_f32_kernel")
# the planned forward's accumulate chain, by kernel name: Cannon's fp32
# accumulator zeroed, K1's fp32 outputs added (ring_rs's partial sums too),
# the sum cast to bf16 (PyTorch's bf16 copy kernel, or a copy that loads or
# stores with a cast); and the device-to-device copies (scatter, gather)
CHAIN_KERNELS = {"zero fp32": ("FillFunctor<float>",), "add fp32": ("CUDAFunctor_add<float>",),
                 "cast": ("bfloat16_copy_kernel", "WithCast"),
                 "device copies": ("Memcpy DtoD",)}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0) or 0)


def profile_split(prof) -> dict:
    """Device time of one profiled forward by kernel name: K1, K2, the
    rest named by its top kernels and top operators, and the accumulate
    chain's kernels (``CHAIN_KERNELS``)."""
    kernels, ops = Counter(), Counter()
    counts = Counter()
    for e in prof.key_averages():
        us = _device_us(e)
        if not us:
            continue
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            if "::" in e.key:   # operators, not runtime events
                ops[e.key] += us
        else:
            kernels[e.key] += us
            counts[e.key] += e.count
    total = sum(kernels.values())
    k1_us = sum(v for key, v in kernels.items() if any(s in key for s in K1_KERNELS))
    k2_us = sum(v for key, v in kernels.items() if any(s in key for s in K2_KERNELS))
    rest = Counter({key: v for key, v in kernels.items()
                    if not any(s in key for s in K1_KERNELS + K2_KERNELS)})
    chain = {cat: {"ms": sum(v for key, v in kernels.items() if any(s in key for s in subs)) / 1e3,
                   "launches": sum(c for key, c in counts.items() if any(s in key for s in subs))}
             for cat, subs in CHAIN_KERNELS.items()}
    return {"device_ms": total / 1e3, "k1_ms": k1_us / 1e3, "k2_ms": k2_us / 1e3,
            "rest_ms": (total - k1_us - k2_us) / 1e3,
            "k1_launches": sum(c for key, c in counts.items() if any(s in key for s in K1_KERNELS)),
            "rest_top_kernels": [{"kernel": key[:160], "ms": v / 1e3, "launches": counts[key]}
                                 for key, v in rest.most_common(8)],
            "top_operators": [{"op": key, "ms": v / 1e3} for key, v in ops.most_common(8)],
            "chain": chain}


def phase_profiler(dev: torch.device) -> dict:
    """Phase 13: one unplanned and one planned danube forward at S = 32768
    under ``torch.profiler`` (no timed window is profiled): device time by
    kernel name into K1, K2 and the rest, and the planned forward's
    accumulate chain; both traces saved (gzip) to ``chiprun_out/``."""
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(get_config(PREFILL_ARCH), attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, PREFILL_S))).to(dev)
    mesh = Mesh(*PLANNED_MESH, device=dev)

    def planned():
        with planned_matmuls(mesh):
            return model.forward(params, tokens)[0]

    fns = {"unplanned": lambda: model.forward(params, tokens)[0], "planned": planned}
    out = {}
    with torch.no_grad():
        for fn in fns.values():   # warm: plans cached, kernels loaded
            fn()
        torch.cuda.synchronize()
        for name, fn in fns.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            split = profile_split(prof)
            raw = os.path.join(OUT_DIR, f"profile_danube_{name}.json")
            prof.export_chrome_trace(raw)
            with open(raw, "rb") as f, gzip.open(raw + ".gz", "wb") as g:
                shutil.copyfileobj(f, g)
            os.remove(raw)
            split["trace"] = os.path.relpath(raw + ".gz", ROOT)
            out[name] = split
            log(f"[profiler] danube forward S={PREFILL_S} {name}: device {split['device_ms']:.1f}ms"
                f" = K1 {split['k1_ms']:.1f} ({split['k1_launches']} launches) + K2 "
                f"{split['k2_ms']:.1f} + rest {split['rest_ms']:.1f}; chain {split['chain']}; "
                f"top rest kernels " + "; ".join(f"{r['kernel'][:70]} {r['ms']:.1f}ms x"
                                                  f"{r['launches']}"
                                                  for r in split['rest_top_kernels'][:5])
                + "; top operators " + ", ".join(f"{r['op']} {r['ms']:.1f}ms"
                                                 for r in split["top_operators"][:5]))
    mesh.close()
    del params
    torch.cuda.empty_cache()
    if not all(v["device_ms"] > 0 and v["k1_ms"] > 0 and v["k2_ms"] > 0 for v in out.values()):
        raise AssertionError(f"torch.profiler saw no device time for K1 or K2: {out}")
    extra = {cat: out["planned"]["chain"][cat]["ms"] - out["unplanned"]["chain"][cat]["ms"]
             for cat in CHAIN_KERNELS}
    log(f"[profiler] planned minus unplanned: device {out['planned']['device_ms'] - out['unplanned']['device_ms']:.1f}ms"
        f", K1 {out['planned']['k1_ms'] - out['unplanned']['k1_ms']:.1f}ms, accumulate chain "
        + ", ".join(f"{cat} {v:.1f}ms" for cat, v in extra.items()))
    return {**out, "chain_extra_ms": extra}


def decode_step_row(timings: list, m: int = 4) -> dict:
    """K1's numbers for one serving forward at M rows (4: a decode step at
    batch 4; 64: the prefill of the 4x16 bucket): the 7 projections of
    each of the 16 layers."""
    by_shape = {tuple(r["shape"]): r for r in timings}
    rows = [by_shape[(m, k, n)] for (k, n) in LAYER_KN]
    layers = get_config("llama3.2-1b").num_layers
    tot = {key: layers * sum(r[key] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_bytes = layers * sum((m * k + k * n + m * n) * 2 for (k, n) in LAYER_KN) / PEAK_BYTES_S
    t_ops = layers * sum(2.0 * m * k * n for (k, n) in LAYER_KN) / PEAK_FLOPS[torch.bfloat16]
    tot["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return tot


def flash_row(report: dict) -> dict:
    """K2's entry: one long-prefill forward's 24 launches at danube's shape,
    all on the wgmma route; each route's time per launch at both timed
    shapes beside it."""
    layers = get_config(PREFILL_ARCH).num_layers
    timings = report["flash_kernel"]["timings"]
    t = timings["danube"]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
        "launches": report["long_prefill"]["launches"]["K2"],
        "launches_by_path": {"long_prefill": report["long_prefill"]["launches"]["K2"],
                             "planned_prefill": sum(report["planned_prefill"]["k2_routes"].values())},
        "routes": {"long_prefill": report["long_prefill"]["k2_routes"],
                   "planned_prefill": report["planned_prefill"]["k2_routes"],
                   "long_prefill_fp32_check": {"fma": report["long_prefill"]["fp32"]["launches"]}},
        "max_abs_err": report["flash_kernel"]["worst_bf16_abs_err"],
        **{key: layers * t[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": t["bound_by"],
        "work": f"one bf16 long-prefill forward of {PREFILL_ARCH}: {layers} launches at "
                f"(B, S_q, S_kv, H_q, H_kv, D, window) = {tuple(t['shape'])}; library: "
                f"scaled_dot_product_attention[{t['sdpa_backend']}]",
        "per_launch": {name: {key: r[key] for key in (
            "shape", "ms", "mma_ms", "bound_ms", "library_ms", "plain_ms", "sdpa_backend",
            "tflops")} for name, r in timings.items()},
        "sources": {"wgmma": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
                    "mma, fma": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 references
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    report = {"build": phase_build()}
    gen = torch.Generator(device=dev).manual_seed(0)
    report["kernel"] = phase_kernel(dev, gen)
    report["model"] = phase_model(dev)
    report["serve"] = phase_serve(dev)
    report["flash_kernel"] = phase_flash_kernel(dev, gen)
    report["long_prefill"] = phase_long_prefill(dev, report["flash_kernel"])
    report["plan_sweep"] = phase_plan_sweep(dev, gen)
    report["planned_serve"] = phase_planned_serve(dev)
    report["planned_prefill"] = phase_planned_prefill(dev)
    report["conformance"] = phase_conformance(dev)
    report["calibrate"] = phase_calibrate(dev)
    report["obs_drift"] = phase_obs_drift(dev, report["calibrate"]["profile_path"])
    report["profiler"] = phase_profiler(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    step = decode_step_row(report["kernel"]["timings"])
    kernels = [{
        "name": "zorder_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/zorder_matmul.cu",
        "replaces": "src/repro/kernels/matmul/kernel.py:46",
        # counted where the wrapper launches: the main path's warmup and
        # captures (a graph replay launches nothing from Python)
        "launches": report["serve"]["path"]["launches"],
        "launches_by_path": {"serve": report["serve"]["path"]["launches"],
                             "serve_graph_replays_per_generate":
                                 report["serve"]["runs"][0]["launches"],
                             "serve_eager_per_generate": report["serve"]["eager_runs"][0]["launches"],
                             "long_prefill": report["long_prefill"]["launches"]["K1"],
                             "planned_serve": report["planned_serve"]["path"]["launches"],
                             "planned_serve_graph_replays_per_generate":
                                 report["planned_serve"]["runs"][0]["launches"],
                             "planned_prefill": report["planned_prefill"]["k1_launches"],
                             "plan_sweep": report["plan_sweep"]["k1_launches"],
                             "conformance": report["conformance"]["k1_launches"],
                             "calibrate_and_tune": report["calibrate"]["k1_launches"],
                             "tuned_planned_serve_graph_replays_per_generate":
                                 report["calibrate"]["tuned_serve"]["runs"][0]["launches"],
                             "profiled_planned_forward":
                                 report["profiler"]["planned"]["k1_launches"]},
        "routes": {"serve": report["serve"]["path"]["routes"],
                   "serve_graph_replays": report["serve"]["runs"][0]["routes"],
                   **{f"serve_{step}_step": r
                      for step, r in report["serve"]["step_device_ms"]["routes"].items()},
                   "long_prefill": report["long_prefill"]["k1_routes"],
                   "planned_serve": report["planned_serve"]["path"]["routes"],
                   "planned_serve_graph_replays": report["planned_serve"]["runs"][0]["routes"],
                   "planned_prefill": report["planned_prefill"]["k1_routes"],
                   "conformance": report["conformance"]["k1_routes"],
                   "calibrate_and_tune": report["calibrate"]["k1_routes"],
                   "tuned_planned_serve_graph_replays":
                       report["calibrate"]["tuned_serve"]["runs"][0]["routes"],
                   "tuned_planned_serve_eager":
                       report["calibrate"]["tuned_serve"]["eager_runs"][0]["routes"]},
        "max_abs_err": max(report["kernel"]["worst_main_abs_err"],
                           *(r["check"]["max_abs_err"]
                             for r in report["flash_kernel"]["projections"])),
        "ms": step["ms"], "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"], "library_ms": step["library_ms"],
        "work": "one bf16 decode step at batch 4: 16 layers x 7 projections",
        "per_route": {
            "thin: decode step, M = 4 (112 products)": step,
            "thin: serving prefill, M = 64 (112 products)":
                decode_step_row(report["kernel"]["timings"], 64),
            "wide: danube forward, M = 32768 (168 products)":
                report["long_prefill"]["k1_per_forward"]},
    }, flash_row(report)]
    report.update(kernels=kernels, nvidia_smi=smi, seconds=time.perf_counter() - t_all,
                  device=torch.cuda.get_device_name(0))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] all phases passed in {report['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
