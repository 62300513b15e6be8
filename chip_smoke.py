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
   (8,32), then ``generate`` on 4 variable-length prompts with 16 new tokens,
   twice, with identical tokens, each run launching K1 exactly 112 x 16
   times (7 projections x 16 layers per forward, 1 prefill + 15 decode
   steps), all on the thin route, 112 per decode step.  Prints TTFT,
   p50/p99 per-token latency and tokens/s, and the device time of one
   prefill and one decode step (each captured in a CUDA graph and
   replayed), which the eager host-clock times contain.
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
   collectives copied.
8. planned-serve -- phase 4's workload through ``Server(mesh=2x2)``: the
   planned prefill's last-token logits within ``PLANNED_LOGITS_TOL`` per
   row of ``mesh=None`` (a ring_rs reducing the wrong way round must land
   outside), identical tokens across two planned runs, token agreement
   with ``mesh=None`` printed, the strategies taken, K1 launches by route,
   TTFT, p50/p99, tokens/s, and one decode step's device time by CUDA
   events, planned and not; then one attempt to capture a planned decode
   step in a CUDA graph, its outcome reported.
9. planned-prefill -- phase 6's danube forward at S = 32768 on the 2x2
   mesh: all 168 products planned, the strategy counts, K1 launches all
   wide and K2's 24 all wgmma; logits within ``PREFILL_LOGITS_TOL`` per row
   of the unplanned forward, with Cannon without its B skew and the
   wrong-way ring_rs (each in every product of its strategy) outside;
   device ms against the unplanned forward, in turns.

On one card the collectives are device copies and "overlap" is only the
order in which the rank threads issue work: no number of phases 7-9 is a
link's.

Then a ``{"kernels": [...]}`` line (each kernel's entry with its launches
per route on each path), the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.  The
full measurements go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import Mesh, _collectives, symmetric_matmul  # noqa: E402
from repro_torch.dist.local import local_matmul  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, mha  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as k2  # noqa: E402
from repro_torch.kernels.matmul import _build, kernel as k1  # noqa: E402
from repro_torch.kernels.matmul import matmul, matmul_ref  # noqa: E402
from repro_torch.models.lm import cross_entropy  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.plan import build_plan, planned_matmuls  # noqa: E402
from repro_torch.runtime.serve import ServeConfig, batch_requests  # noqa: E402
from repro_torch.serve import Server  # noqa: E402

# the module, not the function ``repro_torch.plan.lower_dist`` of its name
lower_dist_mod = importlib.import_module("repro_torch.plan.lower_dist")

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


def phase_serve(dev: torch.device) -> dict:
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    server = Server(model, params, ServeConfig(max_new_tokens=SERVE_NEW, max_seq=64),
                    buckets=SERVE_BUCKETS)
    warm = server.warmup()
    log(f"[serve] {cfg.name}: {n_params / 1e9:.3f}B params bf16 in {init_s:.1f}s; "
        f"warmup " + ", ".join(f"{k} {v['warm_s']:.2f}s" for k, v in warm.items()))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in (5, 9, 12, 16)]
    per_forward = 7 * cfg.num_layers
    want = per_forward * SERVE_NEW
    runs = []
    for rep in range(2):
        k1.reset_launches()
        res = server.generate(prompts)
        launches = k1.launches
        by_route = {r: v for r, v in k1.launches_by_route.items() if v}
        q = res.latency_quantiles_ms()
        runs.append({"bucket": res.bucket, "launches": launches, "ttft_ms": res.ttft_s * 1e3,
                     "p50_ms": q["p50_ms"], "p99_ms": q["p99_ms"],
                     "tokens_per_s": res.tokens_per_s, "wall_s": res.wall_s,
                     "routes": by_route, "tokens": res.new_tokens})
        log(f"[serve] run {rep}: bucket {res.bucket} ttft {res.ttft_s * 1e3:.2f}ms "
            f"p50 {q['p50_ms']:.3f}ms p99 {q['p99_ms']:.3f}ms "
            f"{res.tokens_per_s:.1f} tok/s; K1 launches {launches} (want {want}), "
            f"by route {by_route}")
        if launches != want or by_route != {"thin": want}:
            raise AssertionError(f"K1 launched {launches} times ({by_route}), want {want} "
                                 f"on the thin route ({per_forward} per forward x "
                                 f"{SERVE_NEW} forwards)")
        for toks in res.new_tokens:
            if len(toks) != SERVE_NEW or not all(0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"malformed tokens {toks}")
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError("two generate runs with the same seed disagree")
    alone = server.generate([prompts[2]])
    if alone.new_tokens[0] != runs[0]["tokens"][2]:
        raise AssertionError("a request served alone decodes differently from "
                             "the same request in a batch")
    log(f"[serve] deterministic across runs and batch composition; "
        f"req0 tokens {runs[0]['tokens'][0][:8]}...")
    device_ms = step_device_ms(model, params, dev, SERVE_BUCKETS[0])
    host_p50 = float(np.median([r["p50_ms"] for r in runs]))
    log(f"[serve] device time per step (CUDA-graph replay, bucket 4x16): prefill "
        f"{device_ms['prefill']:.3f}ms, decode {device_ms['decode']:.3f}ms; eager "
        f"decode p50 {host_p50:.3f}ms on the host clock; K1 per step by route: "
        f"{device_ms['routes']}")
    for step, r in device_ms["routes"].items():
        if r != {"thin": per_forward}:
            raise AssertionError(f"one {step} step launched K1 {r}, want {per_forward} thin")
    del server, params
    torch.cuda.empty_cache()
    return {"params": n_params, "init_s": init_s, "warmup": warm, "runs": runs,
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

        _collectives.reset_stats()
        with k1.trace_launches() as trace:
            out = planned()
            torch.cuda.synchronize()
        copied = {kind: dict(v) for kind, v in _collectives.stats.items()}
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
               "copied_bytes_per_rank": moved, "collectives": copied}
        rows.append(row)
        log(f"[plan-sweep] {label:22s} {row['ms']:8.3f}ms (K1 alone {k1_ms:.3f}, scatter of "
            f"both operands {row['scatter_ms']:.3f}, host {host_ms:.1f}ms); K1 {len(trace)} "
            f"launches {routes}; cost words {plan.cost.comm_bytes / 1e6:.2f} MB/rank in "
            f"{plan.cost.msgs} msgs, copied {moved / 1e6:.2f} MB/rank "
            + ", ".join(f"{kd} {v['calls']}x" for kd, v in copied.items() if v["calls"]))
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
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    mesh = Mesh(*PLANNED_MESH, device=dev)
    sc = ServeConfig(max_new_tokens=SERVE_NEW, max_seq=64)
    local = Server(model, params, sc, buckets=SERVE_BUCKETS)
    local.warmup()
    server = Server(model, params, sc, mesh=mesh, buckets=SERVE_BUCKETS)
    warm = server.warmup()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in (5, 9, 12, 16)]
    local_tokens = local.generate(prompts).new_tokens
    runs = []
    for rep in range(2):
        k1.reset_launches()
        before = dict(server.plan_report()["strategies"])
        res = server.generate(prompts)
        launches, by_route = k1.launches, _nonzero(k1.launches_by_route)
        after = server.plan_report()["strategies"]
        taken = {s: v - before.get(s, 0) for s, v in after.items() if v != before.get(s, 0)}
        q = res.latency_quantiles_ms()
        runs.append({"bucket": res.bucket, "launches": launches, "routes": by_route,
                     "strategies": taken, "ttft_ms": res.ttft_s * 1e3, "p50_ms": q["p50_ms"],
                     "p99_ms": q["p99_ms"], "tokens_per_s": res.tokens_per_s,
                     "wall_s": res.wall_s, "tokens": res.new_tokens})
        log(f"[planned-serve] run {rep} on mesh {dict(mesh.shape)}: bucket {res.bucket} ttft "
            f"{res.ttft_s * 1e3:.2f}ms p50 {q['p50_ms']:.3f}ms p99 {q['p99_ms']:.3f}ms "
            f"{res.tokens_per_s:.1f} tok/s; products {taken}; K1 launches {launches} {by_route}")
        if sum(taken.values()) != 7 * cfg.num_layers * SERVE_NEW or set(by_route) != {"thin"}:
            raise AssertionError(f"planned serving ran {taken} products ({by_route}), want "
                                 f"{7 * cfg.num_layers * SERVE_NEW}, all K1 launches thin")
        for toks in res.new_tokens:
            if len(toks) != SERVE_NEW or not all(0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"malformed tokens {toks}")
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError("two planned generate runs disagree")
    agree = sum(x == y for p, r in zip(runs[0]["tokens"], local_tokens) for x, y in zip(p, r))
    log(f"[planned-serve] tokens identical across the two planned runs; {agree} of "
        f"{len(prompts) * SERVE_NEW} agree with mesh=None (printed, not held)")
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
        f"a planned decode step: {step_ms['graph']}")
    mesh.close()
    del server, local, params
    torch.cuda.empty_cache()
    return {"mesh": dict(mesh.shape), "warmup": warm, "runs": runs, "agree_with_local": agree,
            "local_tokens": local_tokens, "prefill_logits": e, "prefill_plans": prefill_plans,
            "control": {wrong: control},
            "step": step_ms}


def planned_step_ms(model, params, mesh, dev: torch.device) -> dict:
    """One decode step at the (4, 16) bucket, eager, by CUDA events:
    mesh=None and planned in turns; then one try at capturing the planned
    step in a CUDA graph (its rank threads launch on the capturing stream)."""
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
    try:
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
    except RuntimeError as e:   # reported: capture across rank threads is not expected to work
        out["graph"] = {"captured": False, "error": f"{type(e).__name__}: {e}"[:400]}
    # the card is still sound after the attempt
    x = torch.randn(64, 256, device=dev).to(torch.bfloat16)
    w = torch.randn(256, 128, device=dev).to(torch.bfloat16)
    if row_err(matmul(x, w), matmul_ref(x, w))["row_rel"] >= ROW_TOL[torch.bfloat16]:
        raise AssertionError("K1 disagrees with its plain version after the graph attempt")
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    step = decode_step_row(report["kernel"]["timings"])
    kernels = [{
        "name": "zorder_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/zorder_matmul.cu",
        "replaces": "src/repro/kernels/matmul/kernel.py:46",
        "launches": report["serve"]["runs"][0]["launches"],
        "launches_by_path": {"serve": report["serve"]["runs"][0]["launches"],
                             "long_prefill": report["long_prefill"]["launches"]["K1"],
                             "planned_serve": report["planned_serve"]["runs"][0]["launches"],
                             "planned_prefill": report["planned_prefill"]["k1_launches"],
                             "plan_sweep": report["plan_sweep"]["k1_launches"]},
        "routes": {"serve": report["serve"]["runs"][0]["routes"],
                   **{f"serve_{step}_step": r
                      for step, r in report["serve"]["step_device_ms"]["routes"].items()},
                   "long_prefill": report["long_prefill"]["k1_routes"],
                   "planned_serve": report["planned_serve"]["runs"][0]["routes"],
                   "planned_prefill": report["planned_prefill"]["k1_routes"]},
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
