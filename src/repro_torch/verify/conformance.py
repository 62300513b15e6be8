"""Conformance checker: executed schedules must match the paper's algebra.

``check(plan)`` closes the loop the paper leaves implicit -- that the
equivariant map IS the schedule, with provable costs (Sec. 2.4) -- by
asserting three independent derivations of a plan's communication agree:

  1. **Structure** (the algebra): every emitted ppermute is a bijection;
     movement perms are torus translations (the movement homomorphism
     commutes with the torus action); the reified ``TorusProgram`` is
     byte-identical to the one derived from the plan's schedule; the
     Fig.-10 diagram equations hold; per-step single-copy memory holds.
  2. **Cost model** (the analytics): the virtual trace's movement words
     equal the schedule-derived word count, equal ``dist.api.estimate``'s
     closed form on the padded problem, and -- for square torus problems --
     the trace's link-words equal ``core.cost.torus_schedule_cost``.
     Measured words must also respect the Irony--Toledo--Tiskin bandwidth
     lower bound at the trace's own memory footprint.
  3. **Execution** (optional, ``measure=True``): the collectives the
     plan's per-rank programs call when ``execute_plan`` runs it on its
     mesh, captured by ``repro_torch.verify.interceptor`` at the
     ``repro_torch.dist._collectives`` seam, form exactly the trace's
     multiset -- kind, group, shard words, and permutation pairs -- and
     every rank calls the same sequence.

Any disagreement raises ``ConformanceError`` naming the leg that broke.
``run_matrix`` sweeps strategy x mesh shape x {square, ragged, batched} x
dtype on single-controller meshes (rank threads on the card, or on the CPU
when asked) -- the pytest ``conformance`` suite and ``chip_smoke.py``'s
conformance phase drive it.

Port of ``repro.verify.conformance``.  The reference's third modality,
the HLO leg (``hlo_collective_bytes``, ``check(..., hlo=True)``), reads the
collective bytes of the plan's compiled XLA program.  The port compiles no
program: ``hlo_collective_bytes`` runs the plan's per-rank programs on
fake tensors under the cost counter (``repro_torch.roofline.hlo_stats``),
which counts each rank's collectives at the seam in the reference's kinds
and output-shape bytes, and the leg applies the reference's rule: bytes
are present if and only if the trace has words.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.cost import bandwidth_lower_bound, torus_schedule_cost
from repro_torch.core.fattree import FatTreeSchedule
from repro_torch.core.schedule import (movement_equations_hold, perm_is_bijection,
                                       perm_translation)
from repro_torch.dist.api import STRATEGIES, estimate
from repro_torch.dist.mesh import Mesh
from repro_torch.plan import build_plan, lower_dist
from repro_torch.plan.ir import TorusProgram
from repro_torch.roofline import hlo_stats

from .interceptor import measure_plan
from .trace import (CollectiveRecord, Trace, canonical_perm, padded_dims,
                    torus_single_copy_ok, trace_plan)


class ConformanceError(AssertionError):
    """An executed or reified schedule disagrees with the algebra/model."""


@dataclasses.dataclass(frozen=True)
class ConformanceReport:
    strategy: str
    mesh_size: int
    grid: Tuple[int, ...]
    padded: Tuple[int, int, int]
    words_per_node: float          # movement/gather/reduce phases
    link_words: Optional[float]    # torus strategies on square problems
    peak_node_words: float
    itt_bound: float
    measured: bool
    hlo_collective_bytes: Optional[float] = None


def _fail(leg: str, msg: str):
    raise ConformanceError(f"[{leg}] {msg}")


def _is_torus_family(plan) -> bool:
    return plan.torus is not None and plan.strategy != "cannon25d"


def _ring_translation(perm, t: int) -> Optional[int]:
    """Constant shift realized by a ring perm over Z_t, or None."""
    perm = tuple(perm)
    mu = None
    for s, d in perm:
        step = (int(d) - int(s)) % t
        if mu is None:
            mu = step
        elif step != mu:
            return None
    if mu not in (None, 0) and len(perm) != t:
        return None
    return mu if mu is not None else 0


def _xor_mask(perm, g: int) -> Optional[int]:
    """Nonzero XOR mask realized by a perm on Z_2^log2(g), or None.  The
    fat-tree exchange is the involution d -> d ^ mask: every pod moves
    (no fixed points, so the canonical perm has all g pairs) and the mask
    is a single constant (its highest bit names the deepest tree level
    crossed)."""
    perm = tuple(perm)
    masks = {int(s) ^ int(d) for s, d in perm}
    if len(masks) != 1:
        return None
    mask = masks.pop()
    if mask == 0 or len(perm) != g:
        return None
    return mask


def predicted_words_per_device(plan) -> float:
    """The analytic cost model's per-device movement words for ``plan`` on
    the padded problem.  Torus-family plans are priced from the schedule
    itself (the Sec.-2.4 functional: each variable set whose movement
    homomorphism is nonzero moves its block once per step); every standard
    strategy is priced by ``dist.api.estimate``'s closed form -- ``check``
    asserts the two derivations agree where both apply."""
    mp, np_, kp = padded_dims(plan)
    p = int(plan.mesh.size) if plan.mesh is not None else 1
    if plan.strategy == "local" or p <= 1:
        return 0.0
    if plan.torus is not None:
        if plan.strategy == "cannon25d":
            c, q, _ = plan.grid
        else:
            c, q = 1, plan.torus.q
        blocks = {
            "A": (mp // q) * (kp // (c * q)),
            "B": (kp // (c * q)) * (np_ // q),
            "C": (mp // q) * (np_ // q),
        }
        moves = plan.schedule.movements() if plan.schedule is not None else None
        if moves is None:
            _fail("structure", "torus plan without solvable movements")
        words = sum(
            (plan.torus.steps - 1) * blk
            for var, blk in blocks.items()
            if (moves[var][0] % q, moves[var][1] % q) != (0, 0)
        )
        if c > 1:
            words += 2 * (c - 1) / c * blocks["C"]
        return float(words)
    if plan.strategy in STRATEGIES:
        est = estimate(plan.strategy, mp, np_, kp, p, dtype_bytes=1,
                       grid=plan.grid or None)
        return float(est.comm_bytes)
    _fail("cost", f"no analytic prediction for strategy {plan.strategy!r}")


def memory_bound_words(plan) -> float:
    """Per-node memory bound, derived from single-copy *shares* (padded
    variable words / P) scaled by each variable's replication factor --
    independent of the tracer's working-set accounting, which ``check``
    compares against it.  Torus/ring families replicate nothing beyond the
    plan's pod factor; the broadcast family (SUMMA/pod25d) holds each
    operand gathered over one mesh axis and (pod25d) the full C partial
    per layer -- that IS its replication, and the bound prices it."""
    mp, np_, kp = padded_dims(plan)
    p = int(plan.mesh.size) if plan.mesh is not None else 1
    share_a = mp * kp / max(p, 1)
    share_b = kp * np_ / max(p, 1)
    share_c = mp * np_ / max(p, 1)
    overlap = bool(getattr(plan, "overlap", False))
    if plan.strategy == "fattree":
        # resident + column-gathered A slab, B shard + row-gathered panel,
        # one fp32 output block (the sliced k-slab reads the gathered
        # panel; it is not an extra resident copy in either derivation)
        s, qx, qy = plan.grid
        return float((1 + qy) * share_a + (1 + qx) * share_b + share_c)
    if plan.strategy in ("summa", "pod25d"):
        if len(plan.grid) >= 3:
            c, qx, qy = plan.grid
        elif plan.strategy == "pod25d":
            c, qx, qy = plan.grid[0], 1, 1
        else:
            c, (qx, qy) = 1, plan.grid
        if overlap and (qx > 1 or qy > 1):
            # decomposed-gather variant: the full B column panel plus
            # double-buffered A/B shards, the per-layer fp32 C partial,
            # and the resident B k-slab (the chain bodies' working set)
            return float(qx * share_b + 2 * share_a + 2 * share_b
                         + c * share_c + (kp // (c * qy)) * (np_ // qy))
        return float(qy * share_a + qx * share_b + c * share_c)
    if plan.strategy == "ring_ag":
        # fused: only one x-chunk resident per step -- true single copy
        return float(share_a + share_b + share_c)
    if plan.strategy == "ring_rs":
        # the full (m, n) partial product is resident before the scatter:
        # t-fold replication of C
        t = plan.grid[0] if plan.grid else p
        return float(share_a + share_b + t * share_c)
    bound = float(max(plan.replication, 1)) * (share_a + share_b + share_c)
    if overlap and plan.torus is not None:
        # double buffering keeps one extra copy of each moving operand
        if canonical_perm(plan.torus.step_a or ()):
            bound += share_a
        if canonical_perm(plan.torus.step_b or ()):
            bound += share_b
    return bound


def compare_records(expected: Sequence[CollectiveRecord],
                    measured: Sequence[CollectiveRecord]) -> None:
    """Exact multiset equality of collective records (phase annotations
    excluded); raises ``ConformanceError`` listing the divergence with
    multiplicities (so a dropped round of an otherwise-identical permute
    still names the key)."""
    from collections import Counter

    exp = Counter(r.key for r in expected)
    got = Counter(r.key for r in measured)
    if exp == got:
        return
    exp_only = sorted((exp - got).items())
    got_only = sorted((got - exp).items())
    _fail("interceptor",
          "executed collectives diverge from the schedule trace; "
          f"trace-only={exp_only[:3]!r} executed-only={got_only[:3]!r} "
          f"(trace {sum(exp.values())} records, "
          f"executed {sum(got.values())})")


def _check_structure(plan, trace: Trace) -> None:
    # movement vectors the *program* realizes, recovered from its perms --
    # a stationary variable has no movement record and contributes mu = 0
    executed_mus = {"A": (0, 0), "B": (0, 0), "C": (0, 0)}
    for rec in trace.records:
        if rec.kind != "ppermute":
            continue
        if not perm_is_bijection(rec.perm, rec.group):
            _fail("structure",
                  f"{rec.phase or 'executed'} perm for {rec.var or '?'} is "
                  f"not a bijection on {rec.group} devices")
        if rec.phase == "movement":
            if plan.torus is not None:
                q = math.isqrt(rec.group)
                mu = perm_translation(rec.perm, q)
                if mu is None:
                    _fail("structure",
                          f"movement perm for {rec.var} is not a torus "
                          "translation: the movement homomorphism does not "
                          "commute with the torus action")
                if rec.var:
                    executed_mus[rec.var] = mu
            elif plan.strategy == "fattree":
                if _xor_mask(rec.perm, rec.group) is None:
                    _fail("structure",
                          f"tree perm for {rec.var} is not an XOR-mask "
                          "involution on the pod axis (the Gray-order slab "
                          "walk is broken)")
            elif plan.strategy in ("ring_ag", "ring_rs"):
                if _ring_translation(rec.perm, rec.group) is None:
                    _fail("structure",
                          f"ring perm for {rec.var} is not a Z_t translation")
    if plan.schedule is not None and plan.torus is not None:
        # Fig.-10 equations against the executed mus (discriminating form:
        # a wrong-but-valid translation fails the diagram here)
        if not movement_equations_hold(plan.schedule, executed_mus):
            _fail("structure",
                  "Fig.-10 movement equations do not hold for the executed "
                  f"movement vectors {executed_mus}")
        if plan.torus != TorusProgram.from_schedule(plan.schedule):
            _fail("structure",
                  "reified TorusProgram does not match the plan's schedule "
                  "(wrong-permutation mutation?)")
        if not torus_single_copy_ok(plan.schedule):
            _fail("structure", "per-step single-copy memory bound violated")


def _check_cost(plan, trace: Trace) -> Tuple[float, Optional[float], float]:
    p = trace.mesh_size
    words_node = trace.movement_words() / p
    predicted = predicted_words_per_device(plan)
    if not math.isclose(words_node, predicted, rel_tol=1e-9, abs_tol=1e-6):
        _fail("cost",
              f"trace movement words/node {words_node} != analytic "
              f"prediction {predicted} for {plan.strategy}")

    link_words = None
    mp, np_, kp = trace.padded
    if _is_torus_family(plan) and plan.schedule is not None \
            and mp == np_ == kp:
        q = plan.torus.q
        link_words = trace.link_words(q)
        report = torus_schedule_cost(plan.schedule, mp)
        if not math.isclose(link_words, report.words_total,
                            rel_tol=1e-9, abs_tol=1e-6):
            _fail("cost",
                  f"trace link-words {link_words} != torus_schedule_cost "
                  f"{report.words_total} (hop counts diverge)")

    bound = memory_bound_words(plan)
    if trace.peak_node_words > bound + 1e-6:
        _fail("memory",
              f"peak per-node words {trace.peak_node_words} exceed "
              f"replication bound {bound}")

    n_eff = (mp * np_ * kp) ** (1.0 / 3.0)
    itt = bandwidth_lower_bound(n_eff, p, max(trace.peak_node_words, 1.0))
    if words_node + 1e-6 < itt:
        _fail("bound",
              f"measured {words_node} words/node beat the Irony-Toledo-"
              f"Tiskin bound {itt} -- the count is wrong")
    return words_node, link_words, itt


def _check_fattree_levels(plan, trace: Trace) -> None:
    """Per-tree-level conformance of a fat-tree plan -- three independent
    derivations of the words entering every tree level must agree exactly:

      1. the plan trace's movement ppermutes, bucketed by the level their
         XOR masks cross (``trace.tree_level_words``);
      2. the analytic closed form ``Estimate.tree_level_words`` on the
         padded problem;
      3. the wreath-product machine model itself:
         ``trace_fattree(FatTreeSchedule(log2 s))`` A events projected to
         pod (k-bit) coordinates, scaled from elements to slab words.

    The top level is additionally pinned to the paper's claim: only A
    crosses the root, moving exactly Mp x Kp words over the run."""
    from .trace import fattree_a_level_words, trace_fattree, tree_level_words

    s = plan.grid[0]
    dt = max(s.bit_length() - 1, 1)
    mp, np_, kp = trace.padded
    traced = tree_level_words(trace)
    est = estimate("fattree", mp, np_, kp, trace.mesh_size, dtype_bytes=1,
                   grid=plan.grid, axes=plan.axes)
    machine = fattree_a_level_words(trace_fattree(FatTreeSchedule(dt)), dt)
    scale = mp * kp / float(s * s)
    for lvl in range(1, dt + 1):
        analytic = est.tree_level_words[lvl - 1]
        projected = machine[lvl] * scale
        if not (math.isclose(traced[lvl], analytic,
                             rel_tol=1e-9, abs_tol=1e-6)
                and math.isclose(traced[lvl], projected,
                                 rel_tol=1e-9, abs_tol=1e-6)):
            _fail("cost",
                  f"tree level {lvl} words diverge: trace={traced[lvl]} "
                  f"analytic={analytic} wreath-projection={projected}")
    if not math.isclose(traced[dt], float(mp * kp),
                        rel_tol=1e-9, abs_tol=1e-6):
        _fail("cost",
              f"root-level words {traced[dt]} != Mp*Kp {mp * kp}: the "
              "paper's only-A-crosses-the-top claim is violated")


def hlo_collective_bytes(plan, dtype=None) -> float:
    """Third measurement modality: run the plan's lowering on fake (B, K)
    and (K, N) operands of ``dtype`` (default the plan's output type, as the
    reference compiles it) on its mesh, every rank's thread under the cost
    counter, and return one rank's collective bytes (the per-device
    program's, as the reference reads them from the compiled HLO)."""
    dtype = dtype if dtype is not None else plan.out_dtype
    flat_m = plan.m * math.prod(plan.batch) if plan.batch else plan.m
    device = plan.mesh.device if plan.mesh is not None else torch.device("cpu")
    with FakeTensorMode():
        a = torch.empty((flat_m, plan.k), dtype=dtype, device=device)
        b = torch.empty((plan.k, plan.n), dtype=dtype, device=device)
        with hlo_stats.counting() as counter:
            lower_dist(plan)(a, b)
    ranks = counter.ranks
    return counter.cost(ranks[0]).coll_bytes if ranks else 0.0


def check(plan, *, measure: bool = False, hlo: bool = False) -> ConformanceReport:
    """Full conformance of ``plan``: structure, cost model, and (optionally)
    the executed collectives and the counted program's collective bytes.
    Raises ``ConformanceError`` on the first broken leg; returns the report
    otherwise."""
    trace = trace_plan(plan)
    _check_structure(plan, trace)
    words_node, link_words, itt = _check_cost(plan, trace)
    if plan.strategy == "fattree":
        _check_fattree_levels(plan, trace)

    if measure:
        cap = measure_plan(plan)
        if not any(p_ is plan for p_ in cap.lowered_plans):
            _fail("interceptor", "lowering hook did not see the plan")
        compare_records(trace.records, cap.records)

    hlo_bytes = None
    if hlo:
        hlo_bytes = hlo_collective_bytes(plan)
        if (hlo_bytes > 0) != (trace.words_total() > 0):
            _fail("hlo",
                  f"counted collective bytes {hlo_bytes} inconsistent "
                  f"with trace words {trace.words_total()}")

    return ConformanceReport(
        strategy=plan.strategy, mesh_size=trace.mesh_size, grid=trace.grid,
        padded=trace.padded, words_per_node=words_node,
        link_words=link_words, peak_node_words=trace.peak_node_words,
        itt_bound=itt, measured=measure, hlo_collective_bytes=hlo_bytes,
    )


def check_capture(cap) -> Dict[str, int]:
    """Conformance of whatever ran under ``intercept()`` (a served
    ``generate``, a planned forward): every rank called the same
    collectives, and their multiset equals the summed traces of the plans
    ``lower_dist`` was asked for, one trace per ``execute_plan`` call (a
    batched pair of operands, which runs the 2-D program once per batch
    element, is outside this rule).  Returns the executed record count per
    kind."""
    from collections import Counter

    why = cap.divergence()
    if why is not None:
        _fail("interceptor", f"the ranks ran different programs: {why}")
    traces: Dict[int, Trace] = {}   # by id: the capture keeps each plan alive
    expected: List[CollectiveRecord] = []
    for plan in cap.lowered_plans:
        if id(plan) not in traces:
            traces[id(plan)] = trace_plan(plan)
        expected.extend(traces[id(plan)].records)
    compare_records(expected, cap.records)
    return dict(Counter(r.kind for r in cap.records))


# ---------------------------------------------------------------------------
# The conformance matrix: strategy x mesh shape x case x dtype
# ---------------------------------------------------------------------------

_CATALOG: Tuple[Tuple[str, Tuple[int, ...], Tuple[str, ...]], ...] = (
    ("cannon", (2, 2), ("x", "y")),
    ("cannon", (3, 3), ("x", "y")),
    ("cannon", (4, 4), ("x", "y")),
    ("summa", (2, 2), ("x", "y")),
    ("summa", (2, 4), ("x", "y")),
    ("summa", (4, 4), ("x", "y")),
    ("pod25d", (4,), ("pod",)),
    ("pod25d", (2, 2, 2), ("pod", "x", "y")),
    ("pod25d", (2, 2, 4), ("pod", "x", "y")),
    ("cannon25d", (1, 2, 2), ("pod", "x", "y")),
    ("cannon25d", (2, 2, 2), ("pod", "x", "y")),
    ("cannon25d", (4, 2, 2), ("pod", "x", "y")),
    ("fattree", (2, 2, 2), ("tree", "x", "y")),
    ("fattree", (4, 2, 2), ("tree", "x", "y")),
    ("ring_ag", (4,), ("t",)),
    ("ring_ag", (2, 2), ("x", "y")),
    ("ring_ag", (8,), ("t",)),
    ("ring_rs", (4,), ("t",)),
    ("ring_rs", (2, 2), ("x", "y")),
    ("ring_rs", (8,), ("t",)),
)

CASES: Dict[str, Dict] = {
    "square": {"m": 24, "n": 24, "k": 24, "batch": ()},
    "ragged": {"m": 13, "n": 7, "k": 11, "batch": ()},
    "batched": {"m": 5, "n": 8, "k": 12, "batch": (3,)},
}


def matrix_cells(num_devices: int):
    """Catalog entries executable with ``num_devices`` devices."""
    return [c for c in _CATALOG if math.prod(c[1]) <= num_devices]


def _overlap_modes(strategy: str, shape: Tuple[int, ...]):
    """Overlap dimension of one matrix cell: strategies with both lowerings
    run staged AND overlapped; the rest run their single (default) form."""
    if strategy in ("cannon", "summa", "cannon25d"):
        return (False, True)
    if strategy == "pod25d" and len(shape) >= 3:
        return (False, True)
    return (None,)


def run_matrix(*, measure: bool = True, hlo: bool = False,
               cases: Optional[Sequence[str]] = None,
               dtypes: Optional[Sequence] = None, num_devices: int = 16,
               device=None) -> List[Dict]:
    """Run the conformance matrix on single-controller meshes of up to
    ``num_devices`` ranks on ``device`` (the card unless the caller asks
    for the CPU); one result row per (strategy, mesh shape, case, dtype,
    overlap) cell, each ``check(plan, measure=measure, hlo=hlo)``.  Never
    raises -- failures are rows with ``ok=False`` so a sweep reports every
    broken cell."""
    cases = tuple(cases) if cases is not None else tuple(CASES)
    dtypes = tuple(dtypes) if dtypes is not None else (torch.float32, torch.bfloat16)
    rows: List[Dict] = []
    meshes: Dict[Tuple, Mesh] = {}
    try:
        for strategy, shape, names in matrix_cells(num_devices):
            for case in cases:
                spec = CASES[case]
                for dtype in dtypes:
                    for mode in _overlap_modes(strategy, shape):
                        row = {"strategy": strategy, "mesh": shape,
                               "case": case, "dtype": str(dtype).replace("torch.", ""),
                               "overlap": bool(mode), "ok": True,
                               "error": "", "words_per_node": 0.0}
                        try:
                            key = (shape, names)
                            if key not in meshes:
                                meshes[key] = Mesh(shape, names, device=device)
                            plan = build_plan(
                                spec["m"], spec["n"], spec["k"],
                                mesh=meshes[key], strategy=strategy,
                                batch=spec["batch"], a_dtype=dtype,
                                b_dtype=dtype, overlap=mode,
                            )
                            row["overlap"] = bool(plan.overlap)
                            rep = check(plan, measure=measure, hlo=hlo)
                            row["words_per_node"] = rep.words_per_node
                        except Exception as e:  # noqa: BLE001 -- reports all
                            row["ok"] = False
                            row["error"] = f"{type(e).__name__}: {e}"
                        rows.append(row)
    finally:
        for mesh in meshes.values():
            mesh.close()
    return rows
