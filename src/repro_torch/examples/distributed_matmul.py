"""Distributed matmul strategies on meshes of rank threads.

    PYTHONPATH=src python -m repro_torch.examples.distributed_matmul [--device cpu]

Runs the solver-derived Cannon schedule and SUMMA (staged, and overlapped
as a chain of one-hop permutes) on a 4x4 torus, the 2.5D pod split on
2x2x2 and the all-gather ring matmul on a ring of 8, each rank a thread of
this process on one device.  Each product is checked against the fp32
product, and its collective bytes per rank, by kind, are counted by the
port's cost counter (``roofline.hlo_stats.counting``, the reference's HLO
kinds) and printed beside the paper's analytic cost model: the counterpart
of ``examples/distributed_matmul.py``, which parses them from the compiled
HLO of 16 fake devices.  Cannon moves only ``collective-permute`` bytes,
staged SUMMA only ``all-gather``, and the overlapped SUMMA only
``collective-permute``.

The operands are bf16, as the reference's; ``--dtype float32`` runs the
same products in fp32.  The counter counts what the program moves: bf16
blocks, and the fp32 partial sums of the 2.5D reduction.  XLA's CPU
compiler turns every bf16 collective of the reference's program into an
f32 one (``f32[128,128] collective-permute``), so the reference prints f32
bytes; the fp32 run here counts those bytes exactly.
"""
from __future__ import annotations

import argparse
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost import torus_schedule_cost
from repro_torch.core.schedule import cannon_schedule
from repro_torch.device import resolve_device
from repro_torch.dist import (Mesh, cannon_matmul, pod25d_matmul, ring_ag_matmul,
                              summa_matmul)
from repro_torch.kernels.matmul import kernel as k1
from repro_torch.plan.lower_dist import P, spmd
from repro_torch.roofline import hlo_stats

Q, N = 4, 512
RING = 8
RING_SHAPE = (512, 256, 256)     # x (s, d) row-sharded, w (d, f) column-sharded


def cases(device: torch.device, dtype: torch.dtype = torch.bfloat16
          ) -> Tuple[List[Mesh], Dict[str, Tuple[Callable, tuple]]]:
    """The demo's meshes (close them when done) and its products: name ->
    (fn, operands), operands of ``dtype`` from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    a, b = normal(N, N), normal(N, N)
    s, d, f = RING_SHAPE
    x, w = normal(s, d), normal(d, f)
    torus = Mesh((Q, Q), ("x", "y"), device=device)
    pod = Mesh((2, 2, 2), ("pod", "x", "y"), device=device)
    ring = Mesh((RING,), ("t",), device=device)
    ring_ag = spmd(lambda xl, wl: ring_ag_matmul(xl, wl, "t"), ring,
                   (P("t", None), P(None, "t")), P(None, "t"))
    out = {
        "cannon": (functools.partial(cannon_matmul, mesh=torus), (a, b)),
        "summa": (functools.partial(summa_matmul, mesh=torus, overlap=False), (a, b)),
        "summa+ov": (functools.partial(summa_matmul, mesh=torus, overlap=True), (a, b)),
        "pod25d": (functools.partial(pod25d_matmul, mesh=pod, pod_axis="pod"), (a, b)),
        "ring_ag": (ring_ag, (x, w)),
    }
    return [torus, pod, ring], out


def run_case(fn: Callable, operands: tuple) -> dict:
    """One counted run: the largest error against the fp32 product, the
    collective bytes of every rank by kind (equal on every rank here) and
    K1's launches by route (none on the CPU)."""
    before = dict(k1.launches_by_route)
    with hlo_stats.counting() as counter:
        out = fn(*operands)
    ref = operands[0].float() @ operands[1].float()
    by_rank = {r: {k: int(v) for k, v in counter.cost(r).coll.items() if v}
               for r in counter.ranks}
    return {"err": (out.float() - ref).abs().max().item(),
            "by_kind": by_rank[min(by_rank)], "ranks": len(by_rank),
            "same_on_every_rank": all(v == by_rank[min(by_rank)] for v in by_rank.values()),
            "k1_routes": {r: v - before[r] for r, v in k1.launches_by_route.items()
                          if v != before[r]},
            "out": out, "ref": ref}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    meshes, products = cases(device, getattr(torch, args.dtype))
    rows = {}
    try:
        print(f"=== {N}x{N} {args.dtype} matmul on a {Q}x{Q} torus of rank threads "
              f"({device}) ===")
        for name in ("cannon", "summa", "summa+ov"):
            rows[name] = r = run_case(*products[name])
            print(f"{name:8s} err={r['err']:.3f}  coll_bytes/dev="
                  f"{sum(r['by_kind'].values()):.3e} by_kind={r['by_kind']}")
        rep = torus_schedule_cost(cannon_schedule(Q), N)
        print(f"paper cost model: cannon words/node = {rep.words_per_node:.3e} "
              f"(x2 bytes bf16 = {2 * rep.words_per_node:.3e} B)")

        print("\n=== 2.5D: contraction split over a pod axis (c=2) ===")
        rows["pod25d"] = r = run_case(*products["pod25d"])
        print(f"pod25d   err={r['err']:.3f}  coll_bytes/dev={sum(r['by_kind'].values()):.3e} "
              f"by_kind={r['by_kind']}")

        print("\n=== ring collective matmuls (1-D torus solutions) ===")
        rows["ring_ag"] = r = run_case(*products["ring_ag"])
        print(f"ring_ag  err={r['err']:.3f}  coll_bytes/dev={sum(r['by_kind'].values()):.3e} "
              f"by_kind={r['by_kind']} (collective-permute chain, overlappable)")
    finally:
        for mesh in meshes:
            mesh.close()
    return {"device": str(device), "dtype": args.dtype, "n": N, "strategies": rows,
            "cost_model": {"words_per_node": rep.words_per_node,
                           "bytes_per_node_bf16": 2 * rep.words_per_node}}


if __name__ == "__main__":
    main()
