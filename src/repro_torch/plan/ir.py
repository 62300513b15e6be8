"""SchedulePlan: the reified schedule IR.

Port of ``repro.plan.ir`` with torch dtypes.  ``build_plan`` is the
planner: it takes a global matmul (shapes, dtypes,
batching) plus a mesh, picks a strategy (cost-model-ranked, topology only as
a filter), and materializes everything the two lowerings need -- mesh-axis
roles, the torus program's placement/movement/collection permutations,
replication factor, padding multiples, and the intra-device tiling order.
Plans are immutable and hashable; ``repro_torch.plan.cache`` memoizes them
on ``(batch, shapes, dtypes, mesh fingerprint, strategy override)``.

The planner ranks with the reference's analytic cost model and constants,
so on the same mesh and problem it picks the reference's plan field for
field.  A calibrated ``profile`` (``repro_torch.obs.MachineProfile``) and
a ``tuning`` table or live tuner (``repro_torch.tune``) replace the
constants with measured seconds, as in the reference: the same formulas,
so the same table entries give the reference's ranking.  Under
``repro_torch.obs`` tracing every call is a ``plan.build`` span, and cache
misses record their build time in ``plan.build_us``.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Any, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.schedule import TorusSchedule, cannon_schedule
from repro_torch.dist.api import Estimate, estimate, overlap_capability

Perm = Tuple[Tuple[int, int], ...]


def _freeze_perm(perm) -> Perm:
    return tuple((int(s), int(d)) for s, d in perm) if perm is not None else ()


@dataclasses.dataclass(frozen=True)
class TorusProgram:
    """The complete ppermute program of a ``TorusSchedule`` as static data.

    Paper mapping: ``skew_*`` are the initial placements l_I (one coset
    representative per block), ``step_*`` the one-step images of the movement
    homomorphism mu, ``collect_c`` the inverse layout restore (empty when C is
    stationary in canonical layout, e.g. Cannon).
    """

    q: int
    steps: int
    shifts: Tuple[Tuple[str, Tuple[int, int]], ...]  # {var: mu} as items
    skew_a: Perm
    skew_b: Perm
    step_a: Perm
    step_b: Perm
    step_c: Perm
    collect_c: Perm

    @classmethod
    def from_schedule(cls, schedule: TorusSchedule) -> "TorusProgram":
        from repro_torch.dist.cannon import lowered_plan

        p = lowered_plan(schedule)
        return cls(
            q=p["q"],
            steps=p["steps"],
            shifts=tuple(sorted(
                (v, (int(mu[0]), int(mu[1]))) for v, mu in p["shifts"].items()
            )),
            skew_a=_freeze_perm(p["skew"]["A"]),
            skew_b=_freeze_perm(p["skew"]["B"]),
            step_a=_freeze_perm(p["step_perm"]["A"]),
            step_b=_freeze_perm(p["step_perm"]["B"]),
            step_c=_freeze_perm(p["step_perm"]["C"]),
            collect_c=_freeze_perm(p["collect_C"]),
        )


@dataclasses.dataclass(frozen=True)
class TilingPlan:
    """Intra-device traversal: the wreath-product bits.

    ``order="zorder"`` is the paper's Sec.-4.3 space-bounded schedule (Morton
    bits of the output-block grid, the order K1's CTAs take output tiles);
    ``rowmajor`` the baseline.  ``block_*`` pick one of K1's compiled block
    shapes instead of its default for the shape.  ``tuned`` marks blocks a
    tuning table substituted (``repro_torch.tune``).  The default plan
    lowers to
    ``repro_torch.dist.local.local_matmul`` verbatim.  The reference's
    ``interpret`` flag (Pallas interpret mode) has no counterpart: a CPU
    tensor runs K1's plain version.
    """

    order: str = "zorder"
    block_m: Optional[int] = None
    block_n: Optional[int] = None
    block_k: Optional[int] = None
    tuned: bool = False

    @property
    def is_default(self) -> bool:
        return (self.order == "zorder" and self.block_m is None
                and self.block_n is None and self.block_k is None
                and not self.tuned)


def mesh_fingerprint(mesh) -> Optional[Tuple]:
    """Hashable identity of a mesh: axis names/sizes, device ids, platform.
    Two meshes with equal fingerprints execute plans identically.  Memoized
    per mesh object (``repro_torch.dist.mesh.Mesh`` is hashable) so the
    per-dispatch cache-key construction does not walk the device array
    every call."""
    if mesh is None:
        return None
    try:
        return _mesh_fingerprint_cached(mesh)
    except TypeError:  # unhashable/unweakrefable mesh stand-in: compute directly
        return _mesh_fingerprint_uncached(mesh)


# Keyed on weakrefs so the memo never pins a mesh (and its rank threads)
# past its natural lifetime: an lru_cache here would keep the last 64 meshes
# alive for the whole process.
_mesh_fingerprint_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _mesh_fingerprint_cached(mesh) -> Tuple:
    fp = _mesh_fingerprint_memo.get(mesh)  # TypeError if unweakrefable
    if fp is None:
        fp = _mesh_fingerprint_uncached(mesh)
        _mesh_fingerprint_memo[mesh] = fp
    return fp


def _mesh_fingerprint_uncached(mesh) -> Tuple:
    names = tuple(mesh.axis_names)
    sizes = tuple(int(mesh.shape[a]) for a in names)
    devs = tuple(
        int(getattr(d, "id", i))
        for i, d in enumerate(getattr(mesh, "devices", ()).flat)
    ) if hasattr(getattr(mesh, "devices", None), "flat") else ()
    platform = getattr(
        getattr(mesh, "devices", None), "flat", [None])[0] if devs else None
    platform = getattr(platform, "platform", None)
    return (names, sizes, devs, platform)


@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """One planned global matmul: (batch..., m, k) x (k, n) on ``mesh``.

    Fields (paper object in brackets):
      strategy     -- solution family executed [the equivariant map f]
      axes / grid  -- mesh-axis roles and sizes [the network group N]
      torus        -- placement/movement/collection perms [l_I, mu, l_I^-1]
      replication  -- operand copies along the pod axis [Sec.-2.5 c-fold]
      tiling       -- intra-device Z-order bits [iterated wreath product]
      pad_a/pad_b  -- block-multiple padding taking the problem onto the grid
      cost         -- the analytic Estimate that ranked this strategy
      overlap      -- execute the double-buffered lowering [max(comp, comm)]
      axis_roles   -- hierarchical (axis, role) pairs [the wreath levels]:
                      ``tree`` is an inter-pod (DCN-class) axis, ``pod`` a
                      replication axis, ``row``/``col`` the intra-pod torus
                      pair, ``ring`` a flattened-ring member
    """

    strategy: str
    m: int
    n: int
    k: int
    batch: Tuple[int, ...]
    out_dtype: torch.dtype
    mesh: Any = dataclasses.field(repr=False)
    mesh_fp: Optional[Tuple] = None
    axes: Tuple[str, ...] = ()
    grid: Tuple[int, ...] = ()
    axis_roles: Tuple[Tuple[str, str], ...] = ()
    replication: int = 1
    pad_a: Tuple[int, int] = (1, 1)
    pad_b: Tuple[int, int] = (1, 1)
    schedule: Optional[TorusSchedule] = None
    torus: Optional[TorusProgram] = None
    tiling: TilingPlan = TilingPlan()
    cost: Optional[Estimate] = None
    overlap: bool = False


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def _square_axes(mesh, names) -> bool:
    return mesh.shape[names[0]] == mesh.shape[names[1]]


# per-strategy role sequence over the resolved axes, leading axis first
_AXIS_ROLE_SEQ = {
    "cannon": ("row", "col"),
    "torus": ("row", "col"),
    "summa": ("row", "col"),
    "cannon25d": ("pod", "row", "col"),
    "pod25d": ("pod", "row", "col"),
    "fattree": ("tree", "row", "col"),
}


def _axis_roles(strategy: str,
                ax: Tuple[str, ...]) -> Tuple[Tuple[str, str], ...]:
    """Hierarchical (axis, role) pairs for ``strategy`` over resolved axes
    ``ax`` -- the machine hierarchy the lowering will drive collectives
    over.  Ring strategies flatten every axis into one logical ring; custom
    torus schedules reuse the cannon roles."""
    if strategy in ("ring_ag", "ring_rs"):
        return tuple((a, "ring") for a in ax)
    seq = _AXIS_ROLE_SEQ.get(strategy, ("row", "col"))
    return tuple(zip(ax, seq))


def mesh_candidates(mesh) -> Tuple[str, ...]:
    """Strategies executable on ``mesh`` -- the topology *filter* (ranking is
    the cost model's job, see ``choose``).  Ring strategies run on any mesh
    (all axes flattened into one logical ring); 2-D torus strategies need two
    axes (Cannon a square pair); the 2.5D family needs a pod axis plus an
    in-layer pair; the fat-tree needs a power-of-two inter-pod tree axis
    over an intra-pod pair."""
    if mesh.size <= 1:
        return ("local",)
    names = tuple(mesh.axis_names)
    cands = ["ring_ag", "ring_rs"]
    if len(names) == 2:
        if _square_axes(mesh, names):
            cands.append("cannon")
        cands.append("summa")
    if len(names) >= 3:
        if mesh.shape[names[1]] == mesh.shape[names[2]]:
            cands.append("cannon25d")
        cands.append("pod25d")
        s = mesh.shape[names[0]]
        if s >= 2 and (s & (s - 1)) == 0:
            cands.append("fattree")
    return tuple(cands)


def _grid_for(mesh, strategy: str,
              ax: Tuple[str, ...]) -> Optional[Tuple[int, ...]]:
    """The device-grid factorization the lowering would run ``strategy``
    on over the resolved axes ``ax``, so the estimate prices the real
    program (a 2x8 mesh's SUMMA is a 2x8 SUMMA, not the canonical 4x4 of
    tp=16)."""
    if strategy in ("cannon", "summa", "cannon25d", "pod25d", "fattree"):
        return tuple(mesh.shape[a] for a in ax)
    return None  # ring family / local: only mesh.size matters


def _local_kernel_shape(strategy: str, grid, m: int, n: int, k: int,
                        tp: int) -> Tuple[int, int, int]:
    """The (m, n, k) of ONE local block-multiply call under ``strategy`` on
    ``grid`` -- the shape K1 sees per step, hence the shape the tuning
    table is consulted at.  Ceil-division approximates the padded shard
    dims; ring/pod strategies with no 2-D grid use ``tp``."""

    def cdiv(x, d):
        return max(-(-int(x) // max(int(d), 1)), 1)

    if strategy in ("cannon", "torus"):
        q = grid[0] if grid else max(int(round(math.sqrt(max(tp, 1)))), 1)
        return cdiv(m, q), cdiv(n, q), cdiv(k, q)
    if strategy == "summa":
        qx, qy = grid[0], grid[1]
        return cdiv(m, qx), cdiv(n, qy), cdiv(k, qx * qy)
    if strategy == "cannon25d":
        c, q = grid[0], grid[1]
        return cdiv(m, q), cdiv(n, q), cdiv(k, c * q)
    if strategy == "pod25d":
        if grid and len(grid) >= 3:
            c, qx, qy = grid[0], grid[1], grid[2]
            return cdiv(m, qx), cdiv(n, qy), cdiv(k, c * qx * qy)
        c = grid[0] if grid else max(tp, 1)
        return m, n, cdiv(k, c)
    if strategy == "fattree":
        s, qx, qy = grid[0], grid[1], grid[2]
        return cdiv(m, qx), cdiv(n, s * qy), cdiv(k, s * qx * qy)
    if strategy == "ring_ag":
        t = grid[0] if grid else max(tp, 1)
        return cdiv(m, t), cdiv(n, t), k
    if strategy == "ring_rs":
        t = grid[0] if grid else max(tp, 1)
        return m, n, cdiv(k, t)
    return m, n, k  # local


def _measured_compute_s(tuning, strategy: str, grid, m: int, n: int, k: int,
                        tp: int, dtype) -> Optional[float]:
    """Total measured local-compute seconds for one strategy cell: the
    tuned per-call kernel seconds (bucket-scaled) times the number of
    local block-multiply calls covering the 2mnk/tp local FLOPs.  None
    when no tuning is given or its table misses the bucket (a live
    ``repro_torch.tune.Tuner`` searches instead of missing)."""
    if tuning is None:
        return None
    lm, ln, lk = _local_kernel_shape(strategy, grid, m, n, k, tp)
    per_call = tuning.compute_seconds(lm, ln, lk, dtype=_dtype_name(
        dtype if dtype is not None else torch.float32))
    if per_call is None:
        return None
    calls = max((2.0 * m * n * k / max(tp, 1)) / (2.0 * lm * ln * lk), 1.0)
    return per_call * calls


def strategy_seconds(est: Estimate, mesh, *, profile=None, tuning=None,
                     dtype=None) -> float:
    """The calibrated ranking key for one ``Estimate`` on ``mesh``: fitted
    α–β comm seconds with the compute term replaced by measured
    tuned-kernel seconds wherever ``tuning`` covers the strategy's local
    kernel bucket.  With tuning but no profile, comm is priced analytically
    (``default_profile``); with neither, the analytic ``total_s``.  This IS
    the sort key ``rank_mesh_strategies`` uses, exported so drift checks
    and reports can reproduce it."""
    eff = profile
    if eff is None and tuning is not None:
        from repro_torch.obs.profile import default_profile

        eff = default_profile()
    if eff is None:
        return est.total_s
    cs = None
    if tuning is not None:
        ax = _plan_axes(mesh, est.strategy, None)
        cs = _measured_compute_s(tuning, est.strategy,
                                 _grid_for(mesh, est.strategy, ax),
                                 est.m, est.n, est.k, est.tp, dtype)
    return eff.seconds(est, compute_s=cs)


def rank_mesh_strategies(m: int, n: int, k: int, mesh,
                         dtype_bytes: int = 2, *,
                         profile=None, tuning=None,
                         dtype=None) -> Tuple[Estimate, ...]:
    """Mesh-applicable strategies priced by ``estimate`` on the grids they
    would actually execute, cheapest first.

    With a calibrated ``profile`` (``repro_torch.obs.MachineProfile``) the
    sort key is its seconds -- the fitted α–β applied to each estimate's
    analytic bytes/message counts -- instead of the datasheet-constant
    ``total_s``; the estimates themselves are identical either way.  Each
    estimate carries the resolved mesh-axis roles (``comm_by_axis``).

    ``tuning`` (a ``repro_torch.tune`` table/tuner, defaulting to the
    profile's embedded table) additionally replaces each strategy's
    peak-FLOPs compute term with measured kernel seconds at its local
    bucket -- ``dtype`` names the operand dtype the table is keyed on (fp32
    when omitted).  See ``strategy_seconds``.
    """
    cands = mesh_candidates(mesh)
    ests = []
    for s in cands:
        ax = _plan_axes(mesh, s, None)
        ests.append(estimate(s, m, n, k, mesh.size, dtype_bytes,
                             grid=_grid_for(mesh, s, ax), axes=ax))
    if tuning is None:
        tuning = getattr(profile, "tuning", None)
    ests.sort(key=lambda e: (strategy_seconds(e, mesh, profile=profile, tuning=tuning,
                                              dtype=dtype),
                             cands.index(e.strategy)))
    return tuple(ests)


# strategies with a per-rank lowering rule (xla_ag/xla_rs exist only in
# the cost model; forcing them is rejected at plan time)
_EXECUTABLE = frozenset(
    ("cannon", "summa", "cannon25d", "pod25d", "fattree", "ring_ag",
     "ring_rs", "local"))

# minimum mesh-axis count per strategy, for early clear errors
_MIN_AXES = {"cannon": 2, "summa": 2, "cannon25d": 3, "pod25d": 1,
             "fattree": 3, "ring_ag": 1, "ring_rs": 1}


def _plan_axes(mesh, strategy: str, axes: Optional[Tuple[str, ...]]):
    """Resolve mesh-axis roles for ``strategy`` (explicit ``axes`` wins)."""
    names = tuple(axes) if axes is not None else tuple(mesh.axis_names)
    need = _MIN_AXES.get(strategy, 0)
    if len(names) < need:
        raise ValueError(
            f"strategy {strategy!r} needs a mesh with >= {need} axes; "
            f"got {names}")
    if axes is not None:
        return names
    if strategy in ("cannon", "summa"):
        return names[:2]
    if strategy in ("cannon25d", "fattree"):
        return names[:3]
    if strategy == "pod25d":
        rest = names[1:]
        return (names[0],) + (rest[:2] if len(rest) >= 2 else ())
    if strategy in ("ring_ag", "ring_rs"):
        return names  # all axes flattened into one logical ring
    return ()


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def build_plan(
    m: int, n: int, k: int, *,
    mesh=None,
    strategy: Optional[str] = None,
    batch: Tuple[int, ...] = (),
    a_dtype: torch.dtype = torch.float32,
    b_dtype: torch.dtype = torch.float32,
    out_dtype: Optional[torch.dtype] = None,
    axes: Optional[Tuple[str, ...]] = None,
    schedule: Optional[TorusSchedule] = None,
    tiling: Optional[TilingPlan] = None,
    profile=None,
    tuning=None,
    overlap: Optional[bool] = None,
    use_cache: bool = True,
) -> SchedulePlan:
    """Plan a global (batch..., m, k) x (k, n) matmul on ``mesh``.

    Strategy selection ranks the mesh-applicable candidates with the analytic
    cost model (``strategy`` forces one; ``schedule`` forces a custom torus
    schedule; a calibrated ``profile`` makes the ranking use its seconds
    instead of datasheet constants, without changing any plan's word
    counts).  ``overlap`` selects the double-buffered lowering: ``None``
    (default) lets the planner pick -- overlapped exactly when the cost
    model predicts ``max(compute, comm) < compute + comm`` strictly --
    ``False`` forces the staged twin, ``True`` demands overlap and raises
    for strategies with no overlapped body.  ``tuning`` (a
    ``repro_torch.tune.TuningTable`` or live ``Tuner``; defaults to the
    profile's embedded table) swaps the compute term of both decisions for
    measured kernel seconds at each strategy's local bucket and folds the
    winning blocks into the plan's ``TilingPlan`` (marked ``tuned``).
    Results are memoized -- see ``repro_torch.plan.cache``.
    """
    from .cache import plan_cache

    if out_dtype is None:
        out_dtype = torch.promote_types(a_dtype, b_dtype)
    tiling = tiling if tiling is not None else TilingPlan()
    key = (
        "plan", tuple(batch), m, n, k, _dtype_name(a_dtype), _dtype_name(b_dtype),
        _dtype_name(out_dtype), mesh_fingerprint(mesh), strategy, axes, schedule, tiling,
        profile, tuning, overlap,
    )
    with obs.span("plan.build", m=m, n=n, k=k, strategy=strategy or "auto"):
        if use_cache:
            cached = plan_cache.get(key)
            if cached is not None:
                return cached
        t0 = time.perf_counter()
        plan = _build_plan_uncached(
            m, n, k, mesh=mesh, strategy=strategy, batch=batch,
            a_dtype=a_dtype, out_dtype=out_dtype, axes=axes,
            schedule=schedule, tiling=tiling, profile=profile,
            tuning=tuning, overlap=overlap,
        )
        if obs.enabled():
            obs.histogram("plan.build_us").observe((time.perf_counter() - t0) * 1e6)
            obs.instant("plan.built", strategy=plan.strategy)
        if use_cache:
            plan_cache.put(key, plan)
    return plan


def _resolve_overlap(strategy: str, grid, cost: Optional[Estimate],
                     overlap: Optional[bool], profile,
                     tuning=None, dtype=None) -> bool:
    """Pick the executed variant: the caller's explicit choice (validated
    against the lowering's capability), or -- when ``overlap`` is None --
    the planner's: overlapped exactly when the cost model predicts a
    strict ``max(compute, comm) < compute + comm`` win (calibrated seconds
    when a profile is given, measured tuned-kernel compute when ``tuning``
    covers the local bucket; ties go to the staged body).  The ring chains
    have no staged twin -- their fused one-hop programs are the overlap."""
    capability = overlap_capability(strategy, grid)
    if overlap is not None:
        if overlap and not capability:
            raise ValueError(
                f"strategy {strategy!r} (grid={grid}) has no overlapped "
                "lowering")
        if not overlap and strategy in ("ring_ag", "ring_rs"):
            raise ValueError(
                f"{strategy} is intrinsically overlapped (the fused ring "
                "chain has no staged twin)")
        return bool(overlap)
    if not capability:
        return False
    if strategy in ("ring_ag", "ring_rs"):
        return True
    if cost is None:
        # custom torus schedules carry no estimate; any torus program
        # double-buffers, and overlap never loses words -- default to it
        return True
    staged = dataclasses.replace(cost, overlapped=False)
    over = dataclasses.replace(cost, overlapped=True)
    eff = profile
    if eff is None and tuning is not None:
        from repro_torch.obs.profile import default_profile

        eff = default_profile()
    if eff is not None:
        cs = _measured_compute_s(tuning, strategy, grid, cost.m, cost.n,
                                 cost.k, cost.tp, dtype)
        return eff.seconds(over, compute_s=cs) < eff.seconds(staged, compute_s=cs)
    return over.total_s < staged.total_s


def _tuned_tiling(tiling: TilingPlan, tuning, strategy: str, grid,
                  m: int, n: int, k: int, tp: int, dtype) -> TilingPlan:
    """Swap a default ``TilingPlan`` for the measured winner's blocks/order
    when the tuning table covers the plan's local kernel bucket (a live
    ``Tuner`` searches the bucket on demand -- this is where serve-warmup
    tuning happens).  Explicit tilings always win over the table."""
    if tuning is None or not tiling.is_default:
        return tiling
    lm, ln, lk = _local_kernel_shape(strategy, grid, m, n, k, tp)
    entry = tuning.entry_for(lm, ln, lk, dtype=_dtype_name(dtype))
    if entry is None:
        return tiling
    return TilingPlan(order=entry.order, block_m=entry.block_m,
                      block_n=entry.block_n, block_k=entry.block_k,
                      tuned=True)


def _build_plan_uncached(m, n, k, *, mesh, strategy, batch, a_dtype,
                         out_dtype, axes, schedule, tiling,
                         profile=None, tuning=None,
                         overlap=None) -> SchedulePlan:
    flat_m = m * math.prod(batch) if batch else m
    dtype_bytes = torch.empty((), dtype=a_dtype).element_size()
    cost = None
    if tuning is None:
        tuning = getattr(profile, "tuning", None)
    if schedule is not None and mesh is None:
        raise ValueError("executing a TorusSchedule requires a mesh")
    if (mesh is None or mesh.size == 1) and schedule is None:
        if overlap:
            raise ValueError(
                "local/single-device plans have no overlapped lowering")
        return SchedulePlan(
            strategy="local", m=m, n=n, k=k, batch=tuple(batch),
            out_dtype=out_dtype, mesh=mesh, mesh_fp=mesh_fingerprint(mesh),
            tiling=_tuned_tiling(tiling, tuning, "local", None,
                                 flat_m, n, k, 1, a_dtype),
            cost=estimate("local", flat_m, n, k, 1, dtype_bytes),
        )
    if schedule is not None:
        strategy = strategy or "torus"
        ax = _plan_axes(mesh, "cannon", axes)
        resolved = _resolve_overlap("cannon", (schedule.q, schedule.q),
                                    None, overlap, profile, tuning, a_dtype)
        tiling = _tuned_tiling(tiling, tuning, "cannon",
                               (schedule.q, schedule.q), flat_m, n, k,
                               schedule.q * schedule.q, a_dtype)
        return _torus_plan(m, n, k, batch, out_dtype, mesh, ax, schedule,
                           tiling, cost=None, strategy=strategy,
                           overlap=resolved)
    if strategy is None:
        ranked = rank_mesh_strategies(flat_m, n, k, mesh, dtype_bytes,
                                      profile=profile, tuning=tuning,
                                      dtype=a_dtype)
        cost = ranked[0]
        strategy = cost.strategy
    elif strategy in _EXECUTABLE:
        ax_cost = _plan_axes(mesh, strategy, axes)
        cost = estimate(strategy, flat_m, n, k, mesh.size, dtype_bytes,
                        grid=_grid_for(mesh, strategy, ax_cost),
                        axes=ax_cost)
    else:
        raise ValueError(
            f"cannot plan strategy {strategy!r}; executable strategies are "
            f"{sorted(_EXECUTABLE)}")

    ax = _plan_axes(mesh, strategy, axes)
    resolved = _resolve_overlap(strategy, _grid_for(mesh, strategy, ax),
                                cost, overlap, profile, tuning, a_dtype)
    tiling = _tuned_tiling(tiling, tuning, strategy,
                           _grid_for(mesh, strategy, ax), flat_m, n, k,
                           mesh.size, a_dtype)
    if cost is not None:
        # the plan's cost prices the variant it will execute, so
        # ``plan.cost.overlapped == plan.overlap`` always holds
        cost = dataclasses.replace(cost, overlapped=resolved)
    if strategy == "local":
        return SchedulePlan(
            strategy="local", m=m, n=n, k=k, batch=tuple(batch),
            out_dtype=out_dtype, mesh=mesh, mesh_fp=mesh_fingerprint(mesh),
            tiling=tiling, cost=cost,
        )
    if strategy == "cannon":
        q = mesh.shape[ax[0]]
        return _torus_plan(m, n, k, batch, out_dtype, mesh, ax,
                           cannon_schedule(q), tiling, cost,
                           strategy="cannon", overlap=resolved)
    if strategy == "summa":
        qx, qy = mesh.shape[ax[0]], mesh.shape[ax[1]]
        return SchedulePlan(
            strategy="summa", m=m, n=n, k=k, batch=tuple(batch),
            out_dtype=out_dtype, mesh=mesh, mesh_fp=mesh_fingerprint(mesh),
            axes=ax, grid=(qx, qy), axis_roles=_axis_roles("summa", ax),
            pad_a=(qx, qx * qy), pad_b=(qx * qy, qy),
            tiling=tiling, cost=cost, overlap=resolved,
        )
    if strategy == "fattree":
        s = mesh.shape[ax[0]]
        if s < 2 or s & (s - 1):
            raise ValueError(
                f"fat-tree needs a power-of-two tree axis with >= 2 pods; "
                f"axis {ax[0]!r} has size {s}")
        qx, qy = mesh.shape[ax[1]], mesh.shape[ax[2]]
        return SchedulePlan(
            strategy="fattree", m=m, n=n, k=k, batch=tuple(batch),
            out_dtype=out_dtype, mesh=mesh, mesh_fp=mesh_fingerprint(mesh),
            axes=ax, grid=(s, qx, qy),
            axis_roles=_axis_roles("fattree", ax),
            pad_a=(qx, s * qx * qy), pad_b=(s * qx * qy, s * qy),
            tiling=tiling, cost=cost, overlap=resolved,
        )
    if strategy == "cannon25d":
        c = mesh.shape[ax[0]]
        q = mesh.shape[ax[1]]
        if mesh.shape[ax[2]] != q:
            raise ValueError("in-layer Cannon needs a square (q x q) layer")
        sched = cannon_schedule(q)
        return SchedulePlan(
            strategy="cannon25d", m=m, n=n, k=k, batch=tuple(batch),
            out_dtype=out_dtype, mesh=mesh, mesh_fp=mesh_fingerprint(mesh),
            axes=ax, grid=(c, q, q), replication=c,
            axis_roles=_axis_roles("cannon25d", ax),
            pad_a=(q, c * q), pad_b=(c * q, q),
            schedule=sched, torus=TorusProgram.from_schedule(sched),
            tiling=tiling, cost=cost, overlap=resolved,
        )
    if strategy == "pod25d":
        c = mesh.shape[ax[0]]
        if len(ax) >= 3:
            qx, qy = mesh.shape[ax[1]], mesh.shape[ax[2]]
            return SchedulePlan(
                strategy="pod25d", m=m, n=n, k=k, batch=tuple(batch),
                out_dtype=out_dtype, mesh=mesh,
                mesh_fp=mesh_fingerprint(mesh),
                axes=ax, grid=(c, qx, qy), replication=c,
                axis_roles=_axis_roles("pod25d", ax),
                pad_a=(qx, c * qx * qy), pad_b=(c * qx * qy, qy),
                tiling=tiling, cost=cost, overlap=resolved,
            )
        return SchedulePlan(
            strategy="pod25d", m=m, n=n, k=k, batch=tuple(batch),
            out_dtype=out_dtype, mesh=mesh, mesh_fp=mesh_fingerprint(mesh),
            axes=ax[:1], grid=(c,), replication=c,
            axis_roles=_axis_roles("pod25d", ax[:1]),
            pad_a=(1, c), pad_b=(c, 1),
            tiling=tiling, cost=cost, overlap=resolved,
        )
    if strategy in ("ring_ag", "ring_rs"):
        t = 1
        for a_ in ax:
            t *= mesh.shape[a_]
        pad_a = (t, 1) if strategy == "ring_ag" else (t, t)
        pad_b = (1, t) if strategy == "ring_ag" else (t, 1)
        return SchedulePlan(
            strategy=strategy, m=m, n=n, k=k, batch=tuple(batch),
            out_dtype=out_dtype, mesh=mesh, mesh_fp=mesh_fingerprint(mesh),
            axes=ax, grid=(t,), axis_roles=_axis_roles(strategy, ax),
            pad_a=pad_a, pad_b=pad_b,
            tiling=tiling, cost=cost, overlap=resolved,
        )
    raise ValueError(f"cannot plan strategy {strategy!r}")


def _torus_plan(m, n, k, batch, out_dtype, mesh, ax, schedule, tiling, cost,
                *, strategy, overlap: bool = False) -> SchedulePlan:
    q = schedule.q
    if mesh.shape[ax[0]] != q or mesh.shape[ax[1]] != q:
        raise ValueError(
            f"mesh axes ({mesh.shape[ax[0]]}, {mesh.shape[ax[1]]}) "
            f"do not span the schedule's {q} x {q} torus")
    if schedule.t != q:
        raise ValueError("executor supports the t = q schedule family")
    return SchedulePlan(
        strategy=strategy, m=m, n=n, k=k, batch=tuple(batch),
        out_dtype=out_dtype, mesh=mesh, mesh_fp=mesh_fingerprint(mesh),
        axes=tuple(ax[:2]), grid=(q, q),
        axis_roles=_axis_roles("torus", tuple(ax[:2])),
        pad_a=(q, q), pad_b=(q, q),
        schedule=schedule, torus=TorusProgram.from_schedule(schedule),
        tiling=tiling, cost=cost, overlap=overlap,
    )
