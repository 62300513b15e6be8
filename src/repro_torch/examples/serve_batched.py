"""Plan-routed batched serving: bucketed warmup and decoding on a mesh.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --no-mesh

Builds a ``repro_torch.serve.Server`` over a 2x2 mesh of rank threads on
one device: warmup runs the declared (batch, seq) buckets, fills the plan
cache with each bucket's solver-derived ``SchedulePlan``s and, on the card,
captures each bucket's prefill and decode step as CUDA graphs; the request
batch is then routed to the nearest warm bucket (left-padded,
offset-corrected) and every decode product executes its planned schedule.
``--no-mesh`` serves the local baseline instead: the same buckets, no plan
engine.  The counterpart of ``examples/serve_batched.py``; the smoke config
of ``--arch`` with random weights from a seeded generator, in its own type
(bf16).  A planned product sums its blocks in another order than the local
one, so a near-tie of two bf16 logits can pick another greedy token.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import Mesh
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve import ServeConfig
from repro_torch.serve import Server

BUCKETS = [(4, 16), (4, 32)]
MAX_SEQ = 128
MESH = ((2, 2), ("x", "y"))


def model_and_params(arch: str, device: DeviceLike = None):
    """The smoke config of ``arch``, its model and its weights from a
    generator seeded 0 on ``device``."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator(device=device).manual_seed(0), device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--no-mesh", action="store_true",
                    help="serve the local baseline instead of plan-routed")
    ap.add_argument("--strategy", default=None,
                    help="pin one schedule family (cannon, summa, ...)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, model, params = model_and_params(args.arch, device)
    mesh = None if args.no_mesh else Mesh(*MESH, device=device)
    try:
        sc = ServeConfig(max_new_tokens=args.max_new, max_seq=MAX_SEQ)
        server = Server(model, params, sc, mesh=mesh, strategy=args.strategy,
                        buckets=BUCKETS)
        warm = server.warmup()
        for label, w in warm.items():
            print(f"warmup {label}: {w['plans']} plans in {w['warm_s']:.2f}s")

        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, size=rng.integers(3, 9)).tolist()
                   for _ in range(args.batch)]
        print(f"arch={cfg.name} {'local' if mesh is None else 'plan-routed 2x2'}: "
              f"serving {len(prompts)} requests, "
              f"lens {[len(p) for p in prompts]}")

        res = server.generate(prompts)
        q = res.latency_quantiles_ms()
        print(f"bucket={res.bucket}: {res.generated_tokens} tokens in "
              f"{res.wall_s:.2f}s ({res.tokens_per_s:.1f} tok/s), "
              f"ttft {res.ttft_s * 1e3:.1f}ms, p50 {q['p50_ms']:.2f}ms")
        for i, toks in enumerate(res.new_tokens):
            print(f"req{i}: ...{toks}")

        rep = server.plan_report()
        k1 = server.cache_report()["kernels"]["zorder_matmul"]
        sw = rep.get("serve_window") or {}
        print(f"plan cache: {rep['cache']['currsize']} plans, serve-window "
              f"hit rate {sw.get('hit_rate')}")
    finally:
        if mesh is not None:
            mesh.close()
    return {"device": str(device), "arch": cfg.name, "dtype": cfg.dtype,
            "mesh": None if mesh is None else dict(mesh.shape), "warmup": warm,
            "prompts": prompts,
            "bucket": res.bucket, "graphs": res.graphs, "new_tokens": res.new_tokens,
            "generated_tokens": res.generated_tokens, "wall_s": res.wall_s,
            "tokens_per_s": res.tokens_per_s, "ttft_s": res.ttft_s, **q,
            "plans": rep["cache"]["currsize"], "hit_rate": sw.get("hit_rate"),
            "strategies": rep["strategies"], "k1": k1}


if __name__ == "__main__":
    main()
