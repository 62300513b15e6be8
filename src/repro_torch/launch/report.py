"""Emit markdown tables from the dry-run / perf-iteration JSONs.

Counterpart of ``repro.launch.report``, table for table, so either
package's dry-run JSON renders the same way:

    PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.json

Two changes: ``plan_cache_table`` reads ``repro_torch.plan.cache_info``,
and the dry-run table's capacity column is the card's: "fits 80G" reads
``memory.fits_card`` (the H100's 80 GiB) where the reference's "fits 16G"
read ``fits_hbm_16g`` (a TPU v5e's).
"""
from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.2f}"


def fmt(x, digits=3):
    if x is None:
        return "-"
    return f"{x:.{digits}e}" if (abs(x) < 1e-3 or abs(x) >= 1e4) else f"{x:.{digits}f}"


def roofline_table(cells, mesh_filter="16x16"):
    rows = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "peak GiB | MODEL_FLOPS | useful frac | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c["mesh"] != mesh_filter or not c.get("ok"):
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt(r['compute_s'])} | "
            f"{fmt(r['memory_s'])} | {fmt(r['collective_s'])} | "
            f"{r['dominant']} | {fmt_bytes(c['memory']['peak_bytes'])} | "
            f"{fmt(r['model_flops'])} | {fmt(r.get('useful_flops_fraction'))} | "
            f"{fmt(r.get('roofline_fraction'), 4)} |"
        )
    return "\n".join(rows)


def dryrun_table(cells):
    rows = [
        "| arch | shape | mesh | compile s | peak GiB/dev | fits 80G | "
        "coll bytes/dev | AG | AR | RS | A2A | CP |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if not c.get("ok"):
            continue
        r = c["roofline"]
        k = r["coll_by_kind"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {c['compile_s']} | "
            f"{fmt_bytes(c['memory']['peak_bytes'])} | "
            f"{'Y' if c['memory'].get('fits_card') else 'N'} | "
            f"{fmt(r['collective_bytes_per_chip'])} | "
            f"{fmt(k.get('all-gather'))} | {fmt(k.get('all-reduce'))} | "
            f"{fmt(k.get('reduce-scatter'))} | {fmt(k.get('all-to-all'))} | "
            f"{fmt(k.get('collective-permute'))} |"
        )
    return "\n".join(rows)


def plan_cache_table(info=None):
    """One-row table over ``repro_torch.plan.cache_info()`` (live process counters
    unless a captured ``info`` dict -- e.g. from a metrics JSON -- is given)."""
    if info is None:
        from repro_torch.plan import cache_info
        info = cache_info()
    hits, misses = info["hits"], info["misses"]
    total = hits + misses
    rate = f"{hits / total:.2f}" if total else "-"
    return "\n".join([
        "| hits | misses | hit rate | currsize | maxsize | evictions |",
        "|---|---|---|---|---|---|",
        f"| {hits} | {misses} | {rate} | {info['currsize']} | "
        f"{info['maxsize']} | {info['evictions']} |",
    ])


def serve_sweep_table(data):
    """Render a ``repro.serve_sweep/v1`` JSON (the reference's
    ``benchmarks/serve_sweep.py``)
    as a markdown table.  Latency quantiles can be null (a 1-token run has
    no timed decode steps) and print as '-'; failed cells print their last
    error line."""

    def v(x):
        if x is None:
            return "-"
        return f"{x:.3f}" if isinstance(x, float) else str(x)

    rows = [
        "| mesh | bucket | strategy | routed | tok/s | tok/s/dev | "
        "ttft ms | p50 ms | p99 ms | hit rate | match |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in data["cells"]:
        if not c.get("ok"):
            err = (c.get("error") or "?").strip().splitlines()[-1][:60]
            rows.append(f"| {c['mesh']} | {c['bucket']} | {c['strategy']} | "
                        f"ERR | - | - | - | - | - | - | {err} |")
            continue
        rows.append(
            f"| {c['mesh']} | {c['bucket']} | {c['strategy']} | "
            f"{'Y' if c['routed'] else 'n'} | {v(c['tokens_per_s'])} | "
            f"{v(c['tokens_per_s_per_device'])} | {v(c['ttft_ms'])} | "
            f"{v(c['p50_ms'])} | {v(c['p99_ms'])} | "
            f"{v(c['cache_hit_rate'])} | "
            f"{'Y' if c['match_baseline'] else 'MISMATCH'} |")
    return "\n".join(rows)


def kernel_metrics_table(metrics):
    """Kernel-side health rows from an ``obs.write_metrics`` snapshot:
    per-call microseconds, roofline fraction, and autotune candidate
    timings when a search ran in-process."""
    names = ("kernel.matmul.us", "kernel.matmul.roofline_fraction", "tune.candidate_us")
    rows = [
        "| metric | n | mean | min | max |",
        "|---|---|---|---|---|",
    ]
    found = False
    for name in names:
        v = metrics.get(name)
        if not isinstance(v, dict):
            continue
        found = True
        rows.append(f"| {name} | {v['count']} | {fmt(v['mean'])} | "
                    f"{fmt(v['min'])} | {fmt(v['max'])} |")
    if not found:
        rows.append("| (no kernel metrics recorded) | - | - | - | - |")
    return "\n".join(rows)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results_v2.json"
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") == "repro.serve_sweep/v1":
        cfg = data["config"]
        print(f"### Serve sweep: {data['arch']} "
              f"(max_new={cfg['max_new_tokens']}, "
              f"{cfg['devices']} devices)\n")
        print(serve_sweep_table(data))
        return
    if "metrics" in data and "cells" not in data:
        # an obs.write_metrics snapshot (e.g. bench_metrics.json)
        print(f"### Kernel metrics (schema {data.get('schema', '?')})\n")
        print(kernel_metrics_table(data["metrics"]))
        return
    cells = data["cells"]
    print("### Roofline (single-pod 16x16)\n")
    print(roofline_table(cells, "16x16"))
    print("\n### Dry-run record (both meshes)\n")
    print(dryrun_table(cells))
    print("\n### Skipped cells\n")
    for arch, shape, why in data.get("skipped", []):
        print(f"* {arch} x {shape}: {why}")
    print("\n### Plan cache\n")
    print(plan_cache_table(data.get("plan_cache")))


if __name__ == "__main__":
    main()
