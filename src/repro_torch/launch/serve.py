"""Serving launcher for the port: bucketed batched decode on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --buckets 4x16 8x32 --max-new 16 [--mesh 2x2 [--strategy cannon]]

Builds random weights from ``--seed`` (no checkpoint download), warms the
(batch, seq) buckets, serves a synthetic request batch through the bucket
router and prints throughput, TTFT, per-token latency quantiles and the
Z-order kernel's launch count (on the card each bucket's steps are
captured as CUDA graphs at warmup and replayed).  ``--mesh RxC`` routes every projection
through the plan engine on an R x C mesh whose ranks all run on the one
device (threads of this process), and prints the strategies it took;
``--strategy`` pins one.  Runs on ``cuda`` unless ``--device cpu`` is given
(then every product takes the kernel's plain version); ``--smoke`` selects
the reduced config.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.dist.mesh import parse_mesh
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve import ServeConfig
from repro_torch.serve import Server


def _parse_bucket(spec: str) -> tuple:
    batch, seq = (int(s) for s in spec.lower().split("x"))
    return (batch, seq)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--buckets", nargs="+", default=["4x16", "8x32"],
                    metavar="BxS", help="warm (batch, seq) serving buckets")
    ap.add_argument("--batch", type=int, default=4,
                    help="synthetic requests to serve")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="route matmuls through the plan engine on this mesh")
    ap.add_argument("--strategy", default=None,
                    help="pin the schedule strategy inside the plan scope")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    sc = ServeConfig(max_new_tokens=args.max_new, max_seq=args.max_seq,
                     temperature=args.temperature)
    mesh = parse_mesh(args.mesh, device=device) if args.mesh else None
    server = Server(model, params, sc, mesh=mesh, strategy=args.strategy,
                    buckets=[_parse_bucket(b) for b in args.buckets])
    for label, w in server.warmup().items():
        captured = (f", {w['graphs']} steps captured in {w['capture_s']:.2f}s"
                    if "graphs" in w else "")
        print(f"[warmup] bucket {label}: {w['warm_s']:.2f}s{captured}")

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=rng.integers(4, 12)).tolist()
               for _ in range(args.batch)]
    res = server.generate(prompts, generator=gen)
    q = res.latency_quantiles_ms()
    print(f"[serve] arch={cfg.name} device={device} batch={args.batch} "
          f"bucket={res.bucket or 'cold'} {res.generated_tokens} tokens in "
          f"{res.wall_s:.3f}s ({res.tokens_per_s:.1f} tok/s) "
          f"ttft={res.ttft_s * 1e3:.2f}ms p50={q['p50_ms']}ms p99={q['p99_ms']}ms")
    for i, toks in enumerate(res.new_tokens):
        print(f"  req{i} (len {len(res.sequences[i]) - len(toks)}): {toks[:8]}...")
    k1 = server.cache_report()["kernels"]["zorder_matmul"]
    print(f"[serve] zorder_matmul launches: {k1['launches']} "
          f"({k1['since_warmup']} since warmup; {k1['replayed']} in graph replays)")
    if mesh is not None:
        rep = server.plan_report()
        print(f"[serve] plan-routed on mesh {rep['mesh']}: strategies {rep['strategies']}, "
              f"plan cache {rep['cache']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
