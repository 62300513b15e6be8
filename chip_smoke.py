#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no result line, non-zero exit):

1. build  -- compile the Z-order matmul kernel (K1) from ``csrc/`` with nvcc.
2. kernel -- K1 against its plain version on the card at every (M, K, N)
   Llama-3.2-1B's serving path gives it (M in 4, 8, 64, 256) plus two ragged
   shapes, fp32 (1e-4 relative) and bf16 (2e-2 relative), both tile orders,
   which must agree bitwise; then K1's time per bf16 shape beside its bound,
   the plain version's time and ``torch.matmul``'s (the yardstick, which the
   port never calls).  Times are CUDA-event times of CUDA-graph replays,
   cycling through enough copies of the weight matrix that it comes from
   device memory, not L2, as in decoding.
3. model  -- a full-width, 2-layer Llama-3.2-1B in fp32: prefill + one
   decode step on the card through K1 and on the CPU through the plain
   version with the same weights; logits agree to 1e-3 relative.
4. serve  -- the full Llama-3.2-1B (16 layers, bf16, random weights from a
   seeded generator) behind ``Server``: warmup over buckets (4,16) and
   (8,32), then ``generate`` on 4 variable-length prompts with 16 new tokens,
   twice, with identical tokens, each run launching K1 exactly 112 x 16
   times (7 projections x 16 layers per forward, 1 prefill + 15 decode
   steps).  Prints TTFT, p50/p99 per-token latency and tokens/s, and the
   device time of one prefill and one decode step (each captured in a CUDA
   graph and replayed), which the eager host-clock times contain.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.  The
full measurements go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.matmul import _build, kernel as k1  # noqa: E402
from repro_torch.kernels.matmul import matmul, matmul_ref  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime.serve import ServeConfig  # noqa: E402
from repro_torch.serve import Server  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): memory 3.35 TB/s,
# bf16 tensor cores 989 TFLOP/s, fp32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MODEL_TOL = 1e-3
MS = (4, 8, 64, 256)
# (K, N) of the 7 projections of a Llama-3.2-1B layer: q, k, v, o, gate, up, down
LAYER_KN = [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
            (2048, 8192), (2048, 8192), (8192, 2048)]
MAIN_SHAPES = [(m, k, n) for m in MS for (k, n) in sorted(set(LAYER_KN))]
RAGGED = [(200, 300, 260), (8, 16, 8)]
L2_BYTES = 50 * 2 ** 20
SERVE_NEW = 16
SERVE_BUCKETS = [(4, 16), (8, 32)]
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
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    secs = time.perf_counter() - t0
    ptxas = path.with_suffix(".log").read_text()
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    log(f"[build] {path.name} ready in {secs:.1f}s")
    return {"library": path.name, "seconds": secs, "ptxas": ptxas}


def phase_kernel(dev: torch.device, gen: torch.Generator) -> dict:
    checks, timings = [], []
    worst_main_abs = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for (m, k, n) in MAIN_SHAPES + RAGGED:
            a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(dtype)
            z = matmul(a, b, order="zorder")
            r = matmul(a, b, order="rowmajor")
            ref = matmul_ref(a, b)
            torch.cuda.synchronize()
            if not torch.equal(z, r):
                raise AssertionError(f"orders disagree at {(m, k, n)} {dtype}")
            diff = (z.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-30)
            ok = rel < TOL[dtype] and bool(torch.isfinite(z).all())
            checks.append({"shape": [m, k, n], "dtype": str(dtype), "max_abs_err": diff,
                           "rel_err": rel, "ok": ok})
            log(f"[kernel] {str(dtype)[6:]:8s} {m:4d}x{k:5d}x{n:5d} "
                f"max_abs_err={diff:.3e} rel={rel:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version at "
                                     f"{(m, k, n)} {dtype}: rel {rel} >= {TOL[dtype]}")
            if dtype == torch.bfloat16 and (m, k, n) in MAIN_SHAPES:
                worst_main_abs = max(worst_main_abs, diff)
    for (m, k, n) in MAIN_SHAPES:
        a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        copies = max(3, math.ceil(3 * L2_BYTES / (k * n * 2)))
        bs = [(torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k))
              .to(torch.bfloat16) for _ in range(copies)]
        calls = [(a, b) for b in bs]
        t = {}
        # in turns: kernel, library, plain, plain, library, kernel
        for name in ("ms", "library_ms", "plain_ms", "plain_ms", "library_ms", "ms"):
            fn = {"ms": matmul, "library_ms": torch.matmul, "plain_ms": matmul_ref}[name]
            t.setdefault(name, []).append(graph_ms(fn, calls))
        bms, by = bound(m, k, n, torch.bfloat16)
        row = {"shape": [m, k, n], "dtype": "bfloat16", "weight_copies": copies,
               **{key: min(v) for key, v in t.items()}, "runs": t,
               "bound_ms": bms, "bound_by": by}
        row["bound_share"] = bms / row["ms"]
        timings.append(row)
        log(f"[kernel-time] bf16 {m:4d}x{k:5d}x{n:5d} K1 {row['ms'] * 1e3:8.2f}us "
            f"bound {bms * 1e3:7.2f}us ({by}, {row['bound_share']:.1%}) "
            f"torch.matmul {row['library_ms'] * 1e3:8.2f}us "
            f"plain {row['plain_ms'] * 1e3:8.2f}us")
        del a, bs, calls
    torch.cuda.empty_cache()
    return {"checks": checks, "timings": timings, "worst_main_abs_err": worst_main_abs}


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
        k1.launches = 0
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
        k1.launches = 0
        res = server.generate(prompts)
        launches = k1.launches
        q = res.latency_quantiles_ms()
        runs.append({"bucket": res.bucket, "launches": launches, "ttft_ms": res.ttft_s * 1e3,
                     "p50_ms": q["p50_ms"], "p99_ms": q["p99_ms"],
                     "tokens_per_s": res.tokens_per_s, "wall_s": res.wall_s,
                     "tokens": res.new_tokens})
        log(f"[serve] run {rep}: bucket {res.bucket} ttft {res.ttft_s * 1e3:.2f}ms "
            f"p50 {q['p50_ms']:.3f}ms p99 {q['p99_ms']:.3f}ms "
            f"{res.tokens_per_s:.1f} tok/s; K1 launches {launches} (want {want})")
        if launches != want:
            raise AssertionError(f"K1 launched {launches} times, want {want} "
                                 f"({per_forward} per forward x {SERVE_NEW} forwards)")
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
        f"decode p50 {host_p50:.3f}ms on the host clock")
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
    with torch.no_grad():
        return {
            "prefill": graph_ms(lambda: model.prefill(params, cache, tokens, offsets), [()]),
            "decode": graph_ms(lambda: model.decode_step(params, cache, tokens[:, -1:],
                                                         seq, offsets), [()]),
        }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def decode_step_row(timings: list) -> dict:
    """K1's numbers for one decode step at batch 4: the 7 projections of
    each of the 16 layers."""
    by_shape = {tuple(r["shape"]): r for r in timings}
    rows = [by_shape[(4, k, n)] for (k, n) in LAYER_KN]
    layers = get_config("llama3.2-1b").num_layers
    tot = {key: layers * sum(r[key] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_bytes = layers * sum((4 * k + k * n + 4 * n) * 2 for (k, n) in LAYER_KN) / PEAK_BYTES_S
    t_ops = layers * sum(2.0 * 4 * k * n for (k, n) in LAYER_KN) / PEAK_FLOPS[torch.bfloat16]
    tot["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return tot


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
        "max_abs_err": report["kernel"]["worst_main_abs_err"],
        "ms": step["ms"], "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"], "library_ms": step["library_ms"],
        "work": "one bf16 decode step at batch 4: 16 layers x 7 projections",
    }]
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
