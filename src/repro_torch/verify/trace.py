"""Schedule-trace recorder: replay a ``SchedulePlan`` on a virtual topology.

Port of ``repro.verify.trace`` over the port's ``SchedulePlan`` and
``TorusProgram`` (``repro_torch.plan.ir``); it imports only
``repro_torch.core``.

The tracer is a second, independent interpreter of the plan IR: where
``repro_torch.plan.lower_dist`` turns a plan into per-rank programs whose
collectives go through ``repro_torch.dist._collectives``, ``trace_plan``
turns the *same* plan into a step-by-step ``Trace`` of collective records
and per-block movement events -- derived purely from the plan's
placement/movement/collection permutations and shapes, never from an
execution.  ``repro_torch.verify.conformance`` then closes the triangle:

    trace records   ==  interceptor-measured collectives   (exact multiset)
    trace words     ==  analytic cost-model words           (exact)

Counting conventions (shared with ``repro_torch.verify.interceptor``):

  ppermute    one shard per listed non-identity (src, dst) pair
  all_gather  each device in the group receives (g - 1) shards
  psum        2 * (g - 1) shards per group (bidirectional ring all-reduce)

The psum convention is the model's, not the thread communicator's: that
one copies g - 1 shards into each member, g * (g - 1) per group.  Records
compare by key, never by bytes, so the two conventions never meet in a
check; a byte figure names the one it uses.

Words are dtype-agnostic element counts, so the fp32 accumulator permutes
of the ring/torus programs compare cleanly across operand dtypes.

Besides plans, the tracer replays the two non-torus machine models of the
paper: ``trace_fattree`` walks ``core.fattree.FatTreeSchedule`` positions
into per-level link traffic, and ``trace_hex`` walks the systolic streams
of ``core.hexarray.HexSchedule`` -- both feed their direct unit tests and
the conformance checks on those models.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cost import perm_link_words
from repro_torch.core.fattree import tree_exchange_perm

Perm = Tuple[Tuple[int, int], ...]


def canonical_perm(perm) -> Perm:
    """Sorted non-identity (src, dst) pairs -- the comparable form of a
    ppermute permutation (identity pairs move no words)."""
    return tuple(sorted(
        (int(s), int(d)) for s, d in perm if int(s) != int(d)))


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective emitted by a lowered schedule.

    ``group`` is the size of the named-axis group the collective runs over;
    a mesh with P devices executes P / group independent copies of it.
    ``phase`` is a tracer-side annotation (placement / movement / collection
    / gather / reduce) that the interceptor cannot observe -- it is excluded
    from the comparison key.
    """

    kind: str                 # "ppermute" | "all_gather" | "psum"
    group: int
    shard_words: int
    perm: Optional[Perm] = None   # canonical, ppermute only
    phase: str = ""
    var: str = ""

    @property
    def key(self) -> Tuple:
        return (self.kind, self.group, self.shard_words, self.perm)

    def words_total(self, mesh_size: int) -> float:
        """Words this collective moves across the whole mesh."""
        copies = mesh_size / self.group
        if self.kind == "ppermute":
            return float(self.shard_words * len(self.perm or ()) * copies)
        if self.kind == "all_gather":
            return float(self.shard_words * (self.group - 1) * self.group
                         * copies)
        if self.kind == "psum":
            return float(2 * (self.group - 1) * self.shard_words * copies)
        raise ValueError(self.kind)


@dataclasses.dataclass(frozen=True)
class Trace:
    """The full communication trace of one lowered plan."""

    strategy: str
    mesh_size: int
    grid: Tuple[int, ...]
    padded: Tuple[int, int, int]       # (Mp, Np, Kp) after grid padding
    records: Tuple[CollectiveRecord, ...]
    peak_node_words: float             # per-node resident working set

    def words_total(self, phases: Optional[Tuple[str, ...]] = None) -> float:
        return sum(r.words_total(self.mesh_size) for r in self.records
                   if phases is None or r.phase in phases)

    def words_per_node(self, phases: Optional[Tuple[str, ...]] = None) -> float:
        return self.words_total(phases) / max(self.mesh_size, 1)

    def movement_words(self) -> float:
        """Words of the cost-model-visible phases: everything except the
        initial placement skew and the final collection restore (the
        analytic model prices steady-state movement only)."""
        return self.words_total(("movement", "gather", "reduce"))

    def link_words(self, q: int) -> float:
        """Torus link-words (words x minimal-route hops) of the movement
        phase -- comparable to ``core.cost.torus_schedule_cost``."""
        total = 0.0
        for r in self.records:
            if r.kind == "ppermute" and r.phase == "movement":
                copies = self.mesh_size / r.group
                total += perm_link_words(r.perm or (), q,
                                         r.shard_words) * copies
        return total

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.kind] = out.get(r.kind, 0) + 1
        return out


def _roundup(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_dims(plan) -> Tuple[int, int, int]:
    """(Mp, Np, Kp) of the 2-D program the lowering actually runs: leading
    batch dims folded into the rows, operands zero-padded to the plan's
    block multiples (``pad_a`` and ``pad_b`` agree on k by construction)."""
    flat_m = plan.m * math.prod(plan.batch) if plan.batch else plan.m
    mp = _roundup(flat_m, plan.pad_a[0])
    kp = _roundup(plan.k, plan.pad_a[1])
    assert kp == _roundup(plan.k, plan.pad_b[0]), "inconsistent k padding"
    np_ = _roundup(plan.n, plan.pad_b[1])
    return mp, np_, kp


def _torus_records(prog, a_blk: int, b_blk: int, c_blk: int,
                   group: int) -> List[CollectiveRecord]:
    """Mirror of ``repro_torch.dist.cannon.torus_program_body``: skew, steps - 1
    movement rounds (identity perms elided exactly as ``_permute`` elides
    them), then the collection restore."""
    recs: List[CollectiveRecord] = []

    def permute(perm, blk, phase, var):
        cp = canonical_perm(perm or ())
        if cp:
            recs.append(CollectiveRecord("ppermute", group, blk, cp,
                                         phase, var))

    permute(prog.skew_a, a_blk, "placement", "A")
    permute(prog.skew_b, b_blk, "placement", "B")
    for _ in range(prog.steps - 1):
        permute(prog.step_a, a_blk, "movement", "A")
        permute(prog.step_b, b_blk, "movement", "B")
        permute(prog.step_c, c_blk, "movement", "C")
    permute(prog.collect_c, c_blk, "collection", "C")
    return recs


def trace_plan(plan) -> Trace:
    """Replay ``plan`` on its virtual topology (torus, pod, or ring) and
    return the communication ``Trace`` the lowering must reproduce."""
    mp, np_, kp = padded_dims(plan)
    strategy = plan.strategy
    mesh_size = int(plan.mesh.size) if plan.mesh is not None else 1
    grid = tuple(plan.grid)
    overlap = bool(getattr(plan, "overlap", False))
    recs: List[CollectiveRecord] = []
    peak = 0.0

    def _ring(g: int) -> Perm:
        return canonical_perm([(d, (d + 1) % g) for d in range(g)])

    def _chain(group: int, shard: int, var: str) -> List[CollectiveRecord]:
        # the one-hop decomposition of a tiled all_gather: (g - 1) ring
        # ppermutes of one shard each -- identical words per device
        return [CollectiveRecord("ppermute", group, shard, _ring(group),
                                 "gather", var)
                for _ in range(group - 1)]

    def _torus_overlap_extra(prog, a_blk: int, b_blk: int) -> float:
        # the double-buffered body keeps step k and the prefetched step
        # k + 1 copy live together -- one extra block per moving operand
        extra = 0.0
        if canonical_perm(prog.step_a or ()):
            extra += a_blk
        if canonical_perm(prog.step_b or ()):
            extra += b_blk
        return extra

    if strategy == "local" or mesh_size <= 1:
        peak = float(mp * kp + kp * np_ + mp * np_)
        return Trace("local", max(mesh_size, 1), grid, (mp, np_, kp),
                     tuple(recs), peak)

    if plan.torus is not None and strategy != "cannon25d":
        q = plan.torus.q
        a_blk = (mp // q) * (kp // q)
        b_blk = (kp // q) * (np_ // q)
        c_blk = (mp // q) * (np_ // q)
        recs = _torus_records(plan.torus, a_blk, b_blk, c_blk, q * q)
        peak = float(a_blk + b_blk + c_blk)
        if overlap:
            peak += _torus_overlap_extra(plan.torus, a_blk, b_blk)
    elif strategy == "summa":
        qx, qy = grid
        a_shard = (mp // qx) * (kp // qy)
        b_shard = (kp // qx) * (np_ // qy)
        if overlap:
            # decomposed gathers: B chain-gathered over the columns, A
            # ring-walked over the rows -- same words, one-hop pieces
            recs = _chain(qx, b_shard, "B") + _chain(qy, a_shard, "A")
            # B panel + double-buffered A and B shards + fp32 acc + b slab
            peak = float(qx * b_shard + 2 * a_shard + 2 * b_shard
                         + (mp // qx) * (np_ // qy)
                         + (kp // qy) * (np_ // qy))
        else:
            recs = [
                CollectiveRecord("all_gather", qy, a_shard, None,
                                 "gather", "A"),
                CollectiveRecord("all_gather", qx, b_shard, None,
                                 "gather", "B"),
            ]
            # gathered row panel + column panel + output block
            peak = float((mp // qx) * kp + kp * (np_ // qy)
                         + (mp // qx) * (np_ // qy))
    elif strategy == "fattree":
        s, qx, qy = grid
        a_shard = (mp // qx) * (kp // (s * qy))
        b_shard = (kp // qx) * (np_ // (s * qy))
        c_shard = (mp // qx) * (np_ // (s * qy))
        # mirror of ``repro_torch.dist.fattree.fattree_body``: one hoisted B
        # panel gather over the rows, then s super-steps, each an A slab
        # gather over the columns followed (except last) by the tree-axis
        # XOR exchange advancing every pod's resident slab
        recs = [CollectiveRecord("all_gather", qx, b_shard, None,
                                 "gather", "B")]
        for t in range(s):
            recs.append(CollectiveRecord("all_gather", qy, a_shard, None,
                                         "gather", "A"))
            if t < s - 1:
                recs.append(CollectiveRecord(
                    "ppermute", s, a_shard,
                    canonical_perm(tree_exchange_perm(s, t)),
                    "movement", "A"))
        # resident slab shard + gathered slab + B shard + gathered B
        # panel + fp32 output block (the sliced B k-slab is a view of the
        # gathered panel, not counted; see conformance.memory_bound_words)
        peak = float((1 + qy) * a_shard + (1 + qx) * b_shard + c_shard)
    elif strategy == "cannon25d":
        c, q, _ = grid
        a_blk = (mp // q) * (kp // (c * q))
        b_blk = (kp // (c * q)) * (np_ // q)
        c_blk = (mp // q) * (np_ // q)
        recs = _torus_records(plan.torus, a_blk, b_blk, c_blk, q * q)
        recs.append(CollectiveRecord("psum", c, c_blk, None, "reduce", "C"))
        peak = float(a_blk + b_blk + c_blk)
        if overlap:
            peak += _torus_overlap_extra(plan.torus, a_blk, b_blk)
    elif strategy == "pod25d":
        if len(grid) >= 3:
            c, qx, qy = grid
            a_shard = (mp // qx) * (kp // (c * qy))
            b_shard = (kp // (c * qx)) * (np_ // qy)
            c_shard = (mp // qx) * (np_ // qy)
            if overlap:
                recs = (_chain(qx, b_shard, "B") + _chain(qy, a_shard, "A")
                        + [CollectiveRecord("psum", c, c_shard, None,
                                            "reduce", "C")])
                peak = float(qx * b_shard + 2 * a_shard + 2 * b_shard
                             + c_shard + (kp // (c * qy)) * (np_ // qy))
            else:
                recs = [
                    CollectiveRecord("all_gather", qy, a_shard, None,
                                     "gather", "A"),
                    CollectiveRecord("all_gather", qx, b_shard, None,
                                     "gather", "B"),
                    CollectiveRecord("psum", c, c_shard, None, "reduce", "C"),
                ]
                peak = float((mp // qx) * (kp // c) + (kp // c) * (np_ // qy)
                             + c_shard)
        else:
            c = grid[0]
            recs = [CollectiveRecord("psum", c, mp * np_, None,
                                     "reduce", "C")]
            peak = float(mp * (kp // c) + (kp // c) * np_ + mp * np_)
    elif strategy in ("ring_ag", "ring_rs"):
        t = grid[0]
        ring = canonical_perm([(d, (d + 1) % t) for d in range(t)])
        if strategy == "ring_ag":
            shard = (mp // t) * kp
            var = "A"
            peak = float((mp // t) * kp + kp * (np_ // t) + mp * (np_ // t))
        else:
            shard = (mp // t) * np_
            var = "C"
            peak = float(mp * (kp // t) + (kp // t) * np_ + mp * np_)
        recs = [CollectiveRecord("ppermute", t, shard, ring,
                                 "movement", var)
                for _ in range(t - 1)]
    else:
        raise ValueError(f"no trace rule for strategy {strategy!r}")

    return Trace(strategy, mesh_size, grid, (mp, np_, kp), tuple(recs), peak)


# ---------------------------------------------------------------------------
# Non-torus machine models: fat-tree and hex-array traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MachineTrace:
    """Per-step (var, src, dst, words) events on a named machine model."""

    model: str
    num_nodes: int
    num_steps: int
    events: Tuple[Tuple[str, int, int, int], ...]  # (var, src, dst, words)

    def words_total(self) -> int:
        return sum(w for _, _, _, w in self.events)


def trace_fattree(sched) -> MachineTrace:
    """Step-by-step movement events of a ``FatTreeSchedule``: A and B
    relocations between consecutive time steps (C is stationary)."""
    n = sched.n
    events = []
    for time in range(sched.num_steps - 1):
        for a in range(n):
            for b in range(n):
                for var, src, dst in (
                    ("A", sched.pos_A(a, b, time), sched.pos_A(a, b, time + 1)),
                    ("B", sched.pos_B(a, b, time), sched.pos_B(a, b, time + 1)),
                ):
                    if src != dst:
                        events.append((var, src, dst, 1))
    return MachineTrace("fattree", sched.num_procs, sched.num_steps,
                        tuple(events))


def fattree_level_words(trace: MachineTrace, d: int) -> Dict[int, int]:
    """Per-level words x link-transits derived from a fat-tree trace: a
    message whose endpoints first differ at bit (L-1) transits 2 links at
    every level <= L -- the same accounting as
    ``core.fattree.FatTreeSchedule.link_traffic`` (its independent oracle)."""
    traffic = {lvl: 0 for lvl in range(1, 2 * d + 1)}
    for _, src, dst, words in trace.events:
        top = (src ^ dst).bit_length()
        for lvl in range(1, top + 1):
            traffic[lvl] += 2 * words
    return traffic


def fattree_a_level_words(trace: MachineTrace, d: int) -> Dict[int, int]:
    """A-movement words per *tree-of-pods* level, from the machine trace.

    The hierarchical lowering's tree axis is the k-dimension of the wreath
    recursion: pod p owns contraction slab p, so processor bit (2l + 1)
    (= k_l) of ``FatTreeSchedule`` is pod bit l of an s = 2^d tree axis.
    Projecting every A event to its k-bits and counting one-directional
    words whose endpoints first differ at pod bit (L - 1) yields the words
    entering tree level L -- B events project to a constant (B_jk never
    leaves its k) and drop out, reproducing "only A crosses the tree".
    Scaled by the slab words, this equals the plan trace's
    ``tree_level_words`` and the analytic ``Estimate.tree_level_words``.
    """

    def kbits(proc: int) -> int:
        k = 0
        for l in range(d):
            k |= ((proc >> (2 * l + 1)) & 1) << l
        return k

    words = {lvl: 0 for lvl in range(1, d + 1)}
    for var, src, dst, w in trace.events:
        if var != "A":
            continue
        ks, kd = kbits(src), kbits(dst)
        if ks == kd:
            continue
        top = (ks ^ kd).bit_length()
        for lvl in range(1, top + 1):
            words[lvl] += w
    return words


def tree_level_words(trace: Trace) -> Dict[int, float]:
    """Mesh-wide words entering each tree level of a fat-tree plan trace.

    Level L (1 = between sibling pods, log2(s) = across the root) is
    entered by a movement-ppermute pair whose endpoints first differ at
    pod bit (L - 1); the pair contributes its shard words to every level
    <= L (one-directional: the involution's two pairs are both counted,
    each once).  Comparable exactly to ``Estimate.tree_level_words`` on
    the padded dims and, scaled, to ``fattree_a_level_words``.
    """
    s = trace.grid[0]
    dt = max(s.bit_length() - 1, 1)
    copies = trace.mesh_size / s
    words = {lvl: 0.0 for lvl in range(1, dt + 1)}
    for r in trace.records:
        if r.kind != "ppermute" or r.phase != "movement" or r.group != s:
            continue
        for src, dst in (r.perm or ()):
            top = (src ^ dst).bit_length()
            for lvl in range(1, min(top, dt) + 1):
                words[lvl] += r.shard_words * copies
    return words


def hex_element_positions(sched, var: str, r: int, s: int):
    """(time, node) path of one stream element through the hex array.

    A_rs is touched by instructions (r, s, k) at times r+s+k; B and C
    likewise with their own index roles -- each element is live for q
    consecutive steps and its node at each is read straight off f."""
    q = sched.q
    out = []
    for free in range(q):
        if var == "A":
            node, t = sched.f(r, s, free)
        elif var == "B":
            node, t = sched.f(free, r, s)
        else:  # C_ki touched by (i, j, k) = (s, free, r)
            node, t = sched.f(s, free, r)
        out.append((t, node))
    out.sort()
    return out


def trace_hex(sched) -> MachineTrace:
    """Movement events of the hex systolic schedule: every stream element's
    hop between consecutive live steps, read off the equivariant map f --
    Kung's "direction, speed and timing" as a literal event list."""
    node_ids: Dict[Tuple[int, int], int] = {}

    def nid(node: Tuple[int, int]) -> int:
        return node_ids.setdefault(node, len(node_ids))

    events = []
    q = sched.q
    for var in ("A", "B", "C"):
        for r in range(q):
            for s in range(q):
                path = hex_element_positions(sched, var, r, s)
                for (t0, n0), (t1, n1) in zip(path, path[1:]):
                    assert t1 == t0 + 1, "stream element must move every step"
                    events.append((var, nid(n0), nid(n1), 1))
    return MachineTrace("hexarray", len(node_ids), sched.num_steps,
                        tuple(events))


def torus_single_copy_ok(schedule) -> bool:
    """Per-step memory invariant of a t = q torus schedule: at every time
    step each node holds exactly one block of each variable (the paper's
    three-words-per-node bound, blocked).  Follows from the placements
    being bijections and the movements being translations -- checked here
    by direct simulation so a mutated program cannot sneak through."""
    q = schedule.q
    for var in ("A", "B", "C"):
        pl = schedule.placement(var)
        mv = schedule.movement(var)
        if pl is None or mv is None:
            return False
        for step in range(schedule.t):
            occupied = set()
            for r in range(q):
                for s in range(q):
                    x = (int(pl[r, s, 0]) + step * mv[0]) % q
                    y = (int(pl[r, s, 1]) + step * mv[1]) % q
                    if (x, y) in occupied:
                        return False
                    occupied.add((x, y))
            if len(occupied) != q * q:
                return False
    return True


