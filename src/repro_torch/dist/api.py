"""Strategy cost model + the public dispatch facade over ``repro_torch.plan``.

Port of ``repro.dist.api``.  ``estimate`` prices a strategy with the paper's
word-counting applied to the reference's analytic TPU constants, copied
into ``repro_torch.core.cost`` (link bandwidth, peak flops) so the port
ranks exactly as the reference does:
compute time is the per-device share of 2mnk flops, communication time is
the strategy's per-device received bytes over one ICI link, and overlapped
strategies pay max(compute, comm) instead of the sum -- that inequality is
exactly why the one-hop solutions win.  Whether a cell is overlapped is no
longer keyed on the strategy *name*: ``overlap_capability`` reports which
lowerings have a double-buffered body (since the overlapped execution mode
that includes SUMMA's decomposed gather chains), and ``estimate``'s
``overlap`` argument pins one variant so the planner can price the
staged-vs-overlapped pair of the same program.

``choose`` ranks the strategies applicable to a device count / mesh
topology with the cost model (topology acts only as a *filter*) and returns
the cheapest; ``symmetric_matmul`` dispatches a global matmul through the
plan engine: ``repro_torch.plan.build_plan`` (cached) + ``execute_plan``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import cost as _cost

STRATEGIES = (
    "cannon", "summa", "cannon25d", "pod25d", "fattree",
    "ring_ag", "ring_rs", "xla_ag", "xla_rs", "local",
)


@dataclasses.dataclass(frozen=True)
class Estimate:
    """Analytic cost record for one (strategy, problem, parallelism) cell.

    ``msgs`` is the per-device collective-round count (ppermute rounds,
    ring steps of a gather/reduce) -- the latency term a calibrated α–β
    ranking (``repro_torch.obs.MachineProfile.seconds``) charges α for; the
    analytic ``total_s`` itself prices bandwidth only.

    ``overlapped`` is the *variant* this cell prices (max vs. sum); it is
    derived from the lowering's capability (``overlap_capability``), not
    the strategy name.  ``comm_by_axis`` splits ``comm_bytes``/``msgs``
    into per-mesh-axis ``(axis_name, bytes, msgs)`` terms when the caller
    supplies the resolved axis roles -- the hook a calibrated profile with
    per-axis ``axis:{name}`` link classes prices each term with its own
    α–β (empty when axes are unknown or the strategy flattens them).

    ``tree_level_words`` (hierarchical strategies only) is the analytic
    per-level traffic of the inter-pod tree axis: entry l-1 is the
    mesh-wide *element* count (dtype-agnostic words, the conformance
    convention) crossing tree level l (1 = leaf pairs, last = root) over
    the whole run.  For the fat-tree schedule level l is crossed by the
    s / 2^(l-1) - 1 exchanges whose Gray mask reaches bit l-1, each moving
    all of A once -- so the root entry is exactly m*k, the paper's "n^2
    words of A cross the top link".
    """

    strategy: str
    m: int
    n: int
    k: int
    tp: int
    compute_s: float
    comm_s: float
    comm_bytes: float
    overlapped: bool
    msgs: int = 0
    comm_by_axis: Tuple[Tuple[str, float, int], ...] = ()
    tree_level_words: Tuple[float, ...] = ()

    @property
    def total_s(self) -> float:
        if self.overlapped:
            return max(self.compute_s, self.comm_s)
        return self.compute_s + self.comm_s


def overlap_capability(strategy: str, grid=None) -> bool:
    """Whether ``strategy``'s lowering has a double-buffered (overlapped)
    body: the ring chains are intrinsically overlapped, the torus family
    prefetches step k+1's A/B permutes under step k's multiply, and SUMMA /
    3-axis pod25d run their gathers as pipelined one-hop chains.  The
    1-axis pod25d slab program (``grid == (c,)``), the hierarchical
    fat-tree program (each super-step's gather feeds the slab multiply it
    precedes -- no independent round to hide it under), and the
    XLA-collective / local baselines have no overlapped variant."""
    if strategy in ("ring_ag", "ring_rs", "cannon", "cannon25d", "summa"):
        return True
    if strategy == "pod25d":
        return grid is None or len(grid) >= 3
    return False


def _square_side(tp: int) -> Optional[int]:
    q = int(math.isqrt(tp))
    return q if q * q == tp and q > 1 else None


def _pod_factor(tp: int) -> Optional[tuple]:
    """Largest c > 1 with tp = q^2 * c and q > 1, preferring small pods."""
    best = None
    for c in (2, 3, 4, 8):
        if tp % c:
            continue
        q = _square_side(tp // c)
        if q:
            best = (q, c)
            break
    return best


def _tree_factor(tp: int) -> tuple:
    """Canonical (s, q) with tp = s * q^2, s a power of two >= 2, for
    grid-less fat-tree estimates (mesh-aware callers always pass the real
    grid); degrades to trivial intra-pod axes when tp has no square
    cofactor."""
    for s in (2, 4, 8):
        if tp % s == 0:
            q = _square_side(tp // s)
            if q:
                return s, q
    return 2, max(int(math.isqrt(max(tp // 2, 1))), 1)


def estimate(strategy: str, m: int, n: int, k: int, tp: int,
             dtype_bytes: int = 2, *, grid=None, axes=None,
             overlap: Optional[bool] = None) -> Estimate:
    """Analytic cost of ``strategy`` for an (m, k) x (k, n) matmul on ``tp``
    devices.  ``total_s`` = max(compute, comm) for overlapped variants,
    sum otherwise.

    ``grid`` optionally pins the device-grid factorization the lowering
    will actually run -- ``(qx, qy)`` for the 2-D torus strategies,
    ``(c, qx, qy)`` (or ``(c,)``) for the 2.5D family -- so mesh-aware
    rankings (``repro_torch.plan.rank_mesh_strategies``) price the real program
    rather than the canonical factorization of ``tp`` derived here.

    ``axes`` optionally names the mesh axes each communication term rides
    (the plan's resolved axis roles, matching ``grid``); when given, the
    estimate carries per-axis ``comm_by_axis`` terms summing exactly to
    ``comm_bytes``/``msgs`` so a profile with per-axis link classes prices
    each axis with its own α–β.

    ``overlap`` pins the variant: ``None`` prices the lowering's default
    (overlapped whenever ``overlap_capability`` allows), ``False`` the
    staged twin, ``True`` demands overlap and raises for strategies with
    no overlapped body.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    capability = overlap_capability(strategy, grid)
    if overlap is None:
        overlapped = capability
    elif overlap and not capability:
        raise ValueError(
            f"strategy {strategy!r} (grid={grid}) has no overlapped lowering")
    else:
        overlapped = bool(overlap)
    compute_s = 2.0 * m * n * k / tp / _cost.PEAK_FLOPS_BF16
    axis_terms = []
    tree_levels: Tuple[float, ...] = ()
    if strategy == "local" or tp == 1:
        comm_bytes = 0.0
        msgs = 0
    elif strategy in ("xla_ag", "ring_ag"):
        # gather the row-sharded (m, k) operand: receive (tp-1)/tp of it
        comm_bytes = dtype_bytes * m * k * (tp - 1) / tp
        msgs = tp - 1
        if axes is not None and len(axes) == 1:
            axis_terms = [(axes[0], comm_bytes, msgs)]
    elif strategy in ("xla_rs", "ring_rs"):
        # reduce-scatter the (m, n) partial output
        comm_bytes = dtype_bytes * m * n * (tp - 1) / tp
        msgs = tp - 1
        if axes is not None and len(axes) == 1:
            axis_terms = [(axes[0], comm_bytes, msgs)]
    elif strategy in ("cannon", "summa"):
        if grid is not None:
            qx, qy = grid[0], grid[1]
        else:
            qx = qy = _square_side(tp) or max(int(math.isqrt(tp)), 2)
        # per device: the (m/qx, k) row panel from qy-1 peers and the
        # (k, n/qy) column panel from qx-1 peers (equal to the classic
        # (q-1) * 2 block panels when qx == qy)
        a_bytes = dtype_bytes * (qy - 1) * (m / qx) * (k / qy)
        b_bytes = dtype_bytes * (qx - 1) * (k / qx) * (n / qy)
        comm_bytes = a_bytes + b_bytes
        # cannon: 2 skews + (q-1) rounds x {A, B}; summa: ring gathers
        msgs = 2 * qx if strategy == "cannon" else (qx - 1) + (qy - 1)
        if axes is not None and len(axes) >= 2:
            # A panels move along the column axis, B panels along the row
            # axis (cannon splits its 2q rounds evenly; summa's chain
            # lengths are the gather-group sizes minus one)
            ma, mb = (qx, qx) if strategy == "cannon" else (qy - 1, qx - 1)
            axis_terms = [(axes[1], a_bytes, ma), (axes[0], b_bytes, mb)]
    elif strategy in ("pod25d", "cannon25d"):
        if grid is not None:
            c = grid[0]
            qx = grid[1] if len(grid) > 1 else 1
            qy = grid[2] if len(grid) > 2 else qx
        else:
            q, c = _pod_factor(tp) or (_square_side(tp) or 2, 1)
            qx = qy = q
        # in-layer panel exchange on the (qx, qy) layer over the k/c slab
        a_bytes = dtype_bytes * (qy - 1) * (m / qx) * (k / (c * qy))
        b_bytes = dtype_bytes * (qx - 1) * (k / (c * qx)) * (n / qy)
        reduce_bytes = \
            dtype_bytes * (c - 1) / c * (m / qx) * (n / qy) * 2  # repl+reduce
        comm_bytes = a_bytes + b_bytes + reduce_bytes
        in_layer = 2 * qx if strategy == "cannon25d" else \
            max((qx - 1) + (qy - 1), 0)
        msgs = in_layer + 2 * (c - 1)  # + bidirectional pod-ring reduce
        if axes is not None and len(axes) >= 3:
            ma, mb = (qx, qx) if strategy == "cannon25d" else \
                (max(qy - 1, 0), max(qx - 1, 0))
            axis_terms = [(axes[2], a_bytes, ma), (axes[1], b_bytes, mb),
                          (axes[0], reduce_bytes, 2 * (c - 1))]
        elif axes is not None and len(axes) == 1:
            axis_terms = [(axes[0], comm_bytes, msgs)]
    elif strategy == "fattree":
        if grid is not None:
            s = grid[0]
            qx = grid[1] if len(grid) > 1 else 1
            qy = grid[2] if len(grid) > 2 else qx
        else:
            s, q = _tree_factor(tp)
            qx = qy = q
        # inter-pod: s - 1 XOR exchanges of each device's A slab shard;
        # intra-pod: per super-step column gather of the slab shard plus
        # one hoisted row gather of the stationary B panel
        a_exch = dtype_bytes * (s - 1) * (m / qx) * (k / (s * qy))
        a_gather = dtype_bytes * s * (qy - 1) * (m / qx) * (k / (s * qy))
        b_gather = dtype_bytes * (qx - 1) * (k / qx) * (n / (s * qy))
        comm_bytes = a_exch + a_gather + b_gather
        msgs = (s - 1) + s * (qy - 1) + (qx - 1)
        if axes is not None and len(axes) >= 3:
            axis_terms = [(axes[0], a_exch, s - 1),
                          (axes[2], a_gather, s * (qy - 1)),
                          (axes[1], b_gather, qx - 1)]
        # per-level tree traffic (mesh-wide element words): level l is
        # crossed by the s/2^(l-1) - 1 exchanges whose mask reaches bit
        # l-1, and each exchange moves all m*k words of A once
        dt = max(s.bit_length() - 1, 1)
        tree_levels = tuple(
            float((s // (1 << (lvl - 1)) - 1) * m * k)
            for lvl in range(1, dt + 1))
    else:  # pragma: no cover
        raise AssertionError(strategy)
    comm_s = comm_bytes / _cost.ICI_BW
    comm_by_axis = tuple(
        (str(a), float(b), int(ms)) for a, b, ms in axis_terms)
    return Estimate(strategy, m, n, k, tp, compute_s, comm_s, comm_bytes,
                    overlapped, msgs, comm_by_axis, tree_levels)


def applicable_strategies(tp: int) -> tuple:
    """Strategies executable on ``tp`` devices (topology permitting)."""
    if tp <= 1:
        return ("local",)
    out = ["ring_ag", "ring_rs"]
    if _square_side(tp):
        out += ["cannon", "summa"]
    if _pod_factor(tp):
        out += ["cannon25d", "pod25d"]
    return tuple(out)


def _mesh_heuristic(mesh, m: int = 1, n: int = 1, k: int = 1) -> str:
    """The pre-plan topology-shape heuristic, kept for reference and as a
    regression foil: beyond the 1-D ring tie-break it ignores the problem
    shape entirely, so it disagrees with the cost model e.g. on a square
    mesh with a huge contraction dimension (Cannon moves O(k) panel bytes;
    reduce-scattering the small output is cheaper).  tests/test_plan.py
    pins one such disagreement."""
    tp = mesh.size
    axes = len(mesh.axis_names)
    if tp == 1:
        return "local"
    if axes == 1:
        # 1-D torus: move whichever tensor is smaller around the ring
        return "ring_ag" if m * k <= m * n else "ring_rs"
    if axes == 2:
        sizes = [mesh.shape[nm] for nm in mesh.axis_names]
        return "cannon" if sizes[0] == sizes[1] else "summa"
    names = mesh.axis_names
    if mesh.shape[names[1]] == mesh.shape[names[2]]:
        return "cannon25d"
    return "pod25d"  # rectangular in-layer axes: SUMMA in-layer


def choose(m: int, n: int, k: int, *, tp: Optional[int] = None, mesh=None,
           dtype_bytes: int = 2) -> str:
    """Pick the cheapest applicable strategy for the problem shape and the
    mesh topology (or bare device count ``tp``).  Topology only *filters*
    the candidates (``repro_torch.plan.mesh_candidates``); the analytic cost
    model ranks them."""
    if mesh is not None:
        if mesh.size == 1:
            return "local"
        from repro_torch.plan import rank_mesh_strategies

        return rank_mesh_strategies(m, n, k, mesh, dtype_bytes)[0].strategy
    if tp is None:
        raise ValueError("choose() needs tp= or mesh=")
    cands = applicable_strategies(tp)
    est = [estimate(s, m, n, k, tp, dtype_bytes) for s in cands]
    return min(est, key=lambda e: (e.total_s, cands.index(e.strategy))).strategy


def symmetric_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh=None,
                     strategy: Optional[str] = None,
                     out_dtype: Optional[torch.dtype] = None,
                     tuning=None,
                     overlap: Optional[bool] = None) -> torch.Tensor:
    """Global (batch..., M, K) x (K, N) matmul dispatched through the plan
    engine: strategy picked by the cost model over the mesh-applicable
    candidates (or forced via ``strategy``), plan memoized in the plan
    cache, leading batch dims folded before planning.  ``tuning`` (a
    ``repro_torch.tune`` table or live ``Tuner``) prices the ranking with
    measured kernel seconds and runs the winning blocks.
    ``overlap`` forces the double-buffered (``True``) or staged
    (``False``) lowering; the default lets the planner pick (see
    ``repro_torch.plan.build_plan``).  ``mesh`` is a
    ``repro_torch.dist.mesh.Mesh``: the product runs as one per-rank
    program per rank of it."""
    from repro_torch.plan import build_plan, execute_plan

    plan = build_plan(
        a.shape[-2], b.shape[-1], a.shape[-1], mesh=mesh, strategy=strategy,
        batch=tuple(a.shape[:-2]),
        a_dtype=a.dtype, b_dtype=b.dtype, out_dtype=out_dtype,
        tuning=tuning, overlap=overlap,
    )
    return execute_plan(plan, a, b)
