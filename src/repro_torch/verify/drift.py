"""Drift check: the measured machine vs the analytic model, on live runs.

Port of ``repro.verify.drift``.  Three legs:

  1. **Collective drift** -- for a strategy x mesh sample, execute the
     cached lowering on a mesh whose ranks are threads of this process
     (``device``: the card, or the CPU) with BOTH observers active: the
     ``repro_torch.obs`` recorder at the dist seam and the
     ``repro_torch.verify`` interceptor patched over it.  The obs
     multiset, the interceptor multiset, and the schedule trace must be
     *identical* (``CollectiveRecord.key`` granularity), and every rank
     must have made the lowest rank's calls.  Any divergence means an
     instrumentation seam rotted or a lowering changed without its trace
     rule.

  2. **Ranking drift** -- calibrate a fresh ``MachineProfile`` on the live
     machine (``obs.probe_links`` on a 2x2 rank-thread mesh) and compare
     ``rank_mesh_strategies(profile=...)`` winners against a stored
     profile (when given) over a shape sample.  A flip is only reported
     when the fresh profile separates the two winners by more than
     ``flip_margin`` (relative seconds), so timing noise cannot flap it.

  3. **Tuning drift** -- when the stored profile embeds a ``repro_torch.tune``
     ``TuningTable``, re-search each stored bucket fresh and, where the
     fresh winner's blocks differ, re-time the *stored* winner's blocks.
     A flip is reported only when the stored blocks are more than
     ``flip_margin`` slower than the fresh winner.  Timing K1 needs the
     card: on the CPU this leg needs a ``timer`` (as ``Tuner`` does).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

# (strategy, mesh shape, axis names) sample -- one cell per lowering family
DRIFT_CELLS: Tuple[Tuple[str, Tuple[int, ...], Tuple[str, ...]], ...] = (
    ("cannon", (2, 2), ("x", "y")),
    ("summa", (2, 2), ("x", "y")),
    ("ring_ag", (4,), ("t",)),
    ("ring_rs", (4,), ("t",)),
    ("cannon25d", (2, 2, 2), ("pod", "x", "y")),
    ("pod25d", (2, 2, 2), ("pod", "x", "y")),
    ("fattree", (2, 2, 2), ("tree", "x", "y")),
)

# (m, n, k) sample spanning the compute-bound / gather-cheap / reduce-cheap
# regimes where rankings genuinely differ
RANKING_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (4096, 4096, 4096),
    (64, 1024, 64),
    (256, 256, 1 << 16),
)


def measure_cell(strategy: str, mesh, m: int = 24, n: int = 24,
                 k: int = 24) -> Dict:
    """Execute one cell with obs + interceptor active and compare the three
    collective multisets (obs == interceptor == trace)."""
    import torch

    from repro_torch import obs
    from repro_torch.plan import build_plan, execute_plan

    from .interceptor import intercept
    from .trace import trace_plan

    plan = build_plan(m, n, k, mesh=mesh, strategy=strategy, use_cache=False)
    a = torch.zeros((m, k), dtype=torch.float32, device=mesh.device)
    b = torch.zeros((k, n), dtype=torch.float32, device=mesh.device)
    with obs.observe() as rec:
        with intercept() as cap:
            with obs.span("plan.execute", strategy=strategy):
                execute_plan(plan, a, b)
                if mesh.device.type == "cuda":
                    torch.cuda.synchronize(mesh.device)
    obs_ms = obs.collective_multiset(rec, strategy=strategy)
    int_ms = Counter(r.key for r in cap.records)
    trace_ms = Counter(r.key for r in trace_plan(plan).records)
    diverged = cap.divergence()
    ok = obs_ms == int_ms == trace_ms and diverged is None
    row = {"strategy": strategy,
           "mesh": tuple(int(s) for s in plan.grid) or (int(mesh.size),),
           "ok": bool(ok),
           "collectives": int(sum(int_ms.values())),
           "error": ""}
    if not ok:
        row["error"] = diverged or (
            f"multiset divergence: obs-only={sorted((obs_ms - int_ms))[:3]} "
            f"interceptor-only={sorted((int_ms - obs_ms))[:3]} "
            f"trace-only={sorted((trace_ms - int_ms))[:3]}")
    return row


def ranking_drift(mesh, stored, fresh, *,
                  shapes: Sequence[Tuple[int, int, int]] = RANKING_SHAPES,
                  flip_margin: float = 0.1) -> List[Dict]:
    """Compare calibrated strategy winners under ``stored`` vs ``fresh``
    profiles; a flip only counts when the fresh profile separates the two
    winners by more than ``flip_margin`` relative seconds."""
    from repro_torch.plan import rank_mesh_strategies

    rows: List[Dict] = []
    for m, n, k in shapes:
        r_stored = rank_mesh_strategies(m, n, k, mesh, profile=stored)
        r_fresh = rank_mesh_strategies(m, n, k, mesh, profile=fresh)
        top_s, top_f = r_stored[0].strategy, r_fresh[0].strategy
        flipped = False
        margin = 0.0
        if top_s != top_f:
            s_stored = fresh.seconds(
                next(e for e in r_fresh if e.strategy == top_s))
            s_fresh = fresh.seconds(r_fresh[0])
            margin = abs(s_stored - s_fresh) / max(s_fresh, 1e-12)
            flipped = margin > flip_margin
        rows.append({"shape": (m, n, k), "stored_top": top_s,
                     "fresh_top": top_f, "flipped": flipped,
                     "margin": margin})
    return rows


def tuning_drift(stored_table, *, flip_margin: float = 0.1, reps: int = 2,
                 max_entries: int = 4, max_candidates: int = 8,
                 device=None, timer=None) -> List[Dict]:
    """Per-bucket re-measurement of a stored ``TuningTable``: fresh-search
    each stored bucket (bounded by ``max_entries``/``max_candidates``) and
    flag entries whose stored blocks have gone stale -- the stored winner
    re-timed on the live machine more than ``flip_margin`` slower than
    the fresh winner.  ``timer`` replaces ``tune.time_candidate``."""
    from repro_torch.tune import time_candidate, tune_shape

    if timer is None:
        def timer(m, n, k, dtype, cand):
            return time_candidate(m, n, k, dtype, cand, reps=reps, device=device)
    rows: List[Dict] = []
    for key, entry in list(stored_table.entries)[:max_entries]:
        dtype, bm, bn, bk = key
        fresh = tune_shape(bm, bn, bk, dtype, max_candidates=max_candidates, timer=timer)
        stored_blocks = (entry.block_m, entry.block_n, entry.block_k,
                         entry.order)
        fresh_blocks = (fresh.block_m, fresh.block_n, fresh.block_k,
                        fresh.order)
        flipped = False
        margin = 0.0
        if stored_blocks != fresh_blocks:
            s_stored = timer(bm, bn, bk, dtype, stored_blocks)
            margin = (s_stored - fresh.seconds) / max(fresh.seconds, 1e-12)
            flipped = margin > flip_margin
        rows.append({"bucket": (bm, bn, bk), "dtype": dtype,
                     "stored": entry.label, "fresh": fresh.label,
                     "flipped": flipped, "margin": margin})
    return rows


def check_drift(*, profile_path: Optional[str] = None, device=None,
                flip_margin: float = 0.1, timer=None) -> Dict:
    """Run the three drift legs on rank-thread meshes on ``device``
    (default ``cuda``); returns a report dict with ``ok`` False when any
    collective multiset diverges (a cell that raises is reported with
    ``ok: False`` and its error) or a stored profile would flip a ranking
    or a tuned bucket beyond the noise margin."""
    from repro_torch import obs
    from repro_torch.device import resolve_device
    from repro_torch.dist.mesh import Mesh

    device = resolve_device(device)
    meshes: Dict[Tuple, Mesh] = {}
    cells: List[Dict] = []
    try:
        for strategy, shape, names in DRIFT_CELLS:
            key = (shape, names)
            if key not in meshes:
                meshes[key] = Mesh(shape, names, device=device)
            try:
                cells.append(measure_cell(strategy, meshes[key]))
            except Exception as e:  # noqa: BLE001 -- report every broken cell
                cells.append({"strategy": strategy, "mesh": shape, "ok": False,
                              "collectives": 0,
                              "error": f"{type(e).__name__}: {e}"})

        stored = obs.load_profile(profile_path) if profile_path else None
        mesh22 = meshes[((2, 2), ("x", "y"))]
        fresh = obs.probe_links(mesh22)
        ranking: List[Dict] = []
        if stored is not None:
            ranking = ranking_drift(mesh22, stored, fresh, flip_margin=flip_margin)
    finally:
        for mesh in meshes.values():
            mesh.close()

    tuning: List[Dict] = []
    if stored is not None and getattr(stored, "tuning", None) is not None:
        tuning = tuning_drift(stored.tuning, flip_margin=flip_margin, device=device,
                              timer=timer)

    ok = all(c["ok"] for c in cells) and not any(
        r["flipped"] for r in ranking) and not any(
        r["flipped"] for r in tuning)
    return {"ok": ok, "cells": cells, "ranking": ranking,
            "tuning": tuning,
            "fresh_profile": fresh.to_json(),
            "stored_profile_path": profile_path}
