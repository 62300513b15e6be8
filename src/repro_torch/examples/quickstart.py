"""Quickstart: the paper's procedure end to end on one page.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. SOLVE the commutative diagram for the 2-D torus: Cannon falls out.
2. COST the solutions (paper Sec. 2.4) and check the lower bound.
3. EXECUTE the derived schedule in the algebraic simulator (see
   ``repro_torch.examples.distributed_matmul`` for rank meshes).
4. The same algebra at the card's cache levels: the Z-order matmul kernel
   (K1), in fp32 (its fma route) and in bf16 (its wide route), against its
   plain version.

Steps 1-3 are the port's copy of the reference's algebra and print what
``examples/quickstart.py`` prints.  Step 4 runs on the card unless
``--device cpu`` is given; there the kernel's plain version multiplies.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import cannon_schedule, is_cannon_like, solve_torus
from repro_torch.core.cost import bandwidth_lower_bound, torus_schedule_cost
from repro_torch.core.hexarray import HexSchedule
from repro_torch.device import resolve_device
from repro_torch.kernels.matmul import kernel as k1
from repro_torch.kernels.matmul import matmul, matmul_ref

Q = 5
N_COST = 4096
K1_SHAPE = (256, 256, 256)


def kernel_rows(device: torch.device, shape=K1_SHAPE) -> Dict[str, dict]:
    """K1 at ``shape`` (m, k, n) in fp32 and bf16 against ``matmul_ref``:
    each type's route, the launches it made by route (none on the CPU),
    the worst row's relative L2 error and the largest absolute error."""
    m, k, n = shape
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn(m, k, generator=gen, device=device).to(dtype)
        b = torch.randn(k, n, generator=gen, device=device).to(dtype)
        before = dict(k1.launches_by_route)
        got = matmul(a, b)
        moved = {r: v - before[r] for r, v in k1.launches_by_route.items() if v != before[r]}
        ref = matmul_ref(a, b).float()
        diff = got.float() - ref
        rel = diff.norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)
        out[str(dtype).removeprefix("torch.")] = {
            "route": k1.route(m, n, k, dtype), "launched": moved,
            "row_rel": rel.max().item(), "max_abs_err": diff.abs().max().item(),
            "finite": bool(torch.isfinite(got).all())}
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    q = Q
    print(f"=== Solving the q={q} torus commutative diagram ===")
    sols = solve_torus(q)
    print(f"{len(sols)} valid equivariant schedules; min hop cost "
          f"{sols[0].hop_cost} (paper: 2 = two one-hop movers, one stationary)")
    best = sols[0]
    movements = dict(best.movements)
    print(f"best movements: {movements}  cannon-like: {is_cannon_like(best)}")

    cs = cannon_schedule(q)
    found = any(s.schedule.M == cs.M for s in sols)
    print(f"\nCannon's own matrix found: {found}")
    pl = cs.placement("A")
    skew = [tuple(int(v) for v in pl[1, s]) for s in range(q)]
    print("derived initial placement of A (row i=1):", skew,
          " <- the classic skew P_{i, j-i}")

    n, p = N_COST, q * q
    rep = torus_schedule_cost(cs, n)
    lb = bandwidth_lower_bound(n, p, n * n / p)  # Cannon's one-block regime
    factor = rep.words_per_node / max(lb, 1e-9)
    print(f"\nblocked Cannon comm, n={n}, p={p}: "
          f"{rep.words_per_node:.3e} words/node "
          f"(lower bound {lb:.3e}; factor {factor:.1f}x)")

    print("\n=== Executing the schedule (algebraic simulator) ===")
    rng = np.random.default_rng(0)
    A = rng.random((q, q))
    B = rng.random((q, q))
    C = np.zeros((q, q))
    for i in range(q):
        for j in range(q):
            for k in range(q):
                C[k, i] += A[i, j] * B[j, k]
    simulated = bool(np.allclose(C, (A @ B).T))
    print("C == A@B:", simulated)

    print("\n=== Same algebra, hex VLSI array (paper Sec. D.2) ===")
    props = HexSchedule(q=4).systolic_properties()
    print("systolic properties:", props)

    print(f"\n=== Same algebra, the card's cache levels: Z-order K1 on {device} ===")
    rows = kernel_rows(device)
    for name, r in rows.items():
        print(f"{name:8s} {'x'.join(map(str, K1_SHAPE))} route {r['route']} "
              f"(launched {r['launched'] or 'none: plain version'}): max err vs plain "
              f"{r['max_abs_err']:.3e}, worst row {r['row_rel']:.3e}")

    return {"device": str(device), "schedules": len(sols), "min_hop_cost": sols[0].hop_cost,
            "movements": movements, "cannon_like": is_cannon_like(best),
            "cannon_found": found, "skew": skew, "words_per_node": rep.words_per_node,
            "lower_bound": lb, "factor": factor, "simulated": simulated,
            "systolic": props, "k1": rows}


if __name__ == "__main__":
    main()
