"""Cost counter: FLOPs, device-memory bytes and collective bytes of a
program as it runs, op by op.

Counterpart of ``repro.roofline.hlo_stats``.  The reference reads the
optimized HLO text of a compiled program; the port compiles no program, so
there is no text to read.  It counts the operations themselves instead:
``counting()`` pushes a ``TorchDispatchMode`` that sees every aten
operation after autograd and the composite ops have lowered (``einsum``
and ``matmul`` arrive as ``mm`` / ``bmm``), and the port's kernels as
one op each (``repro_torch::zorder_matmul``, K1,
``repro_torch::flash_attention``, K2, and ``repro_torch::decode_attention``,
D1: all are registered ops, and under an active dispatch mode every call
takes them).  It works on real tensors and
under ``FakeTensorMode``, so a cell at full size touches no memory.

Per op, the reference's conventions (``repro/roofline/hlo_stats.py``):

    dot (mm, bmm, addmm, baddbmm, ...) : 2 * out elements * contracted dim
                                          flops; operands + output bytes
    K1  (zorder_matmul)                : 2 m n k flops; A + B + C bytes
    K2  (flash_attention)              : 4 D B H_q flops per valid (query,
                                          key) pair (``attention_pairs``,
                                          K2's causal alignment); Q, K, V
                                          read once, O written once
    D1  (decode_attention)             : 2 (Dk + Dv) flops per valid slot
                                          and query head; Q read once, the
                                          valid slots' K and V once (all
                                          of V for a row with no valid
                                          key), O written once; every slot
                                          valid on fake positions
    gather (embedding, index_select,   : 1 flop per output element; 2x the
            gather, index, take)         output bytes (what is read is
                                          what is written)
    in-place slice write (``copy_``    : 2x the updated slab's bytes (the
      into a view of a larger buffer,    reference's dynamic-update-slice);
      index_put_, index_copy_,           no flops
      slice_scatter, ...)
    views, reshapes, allocations       : free (the reference's _FREE_OPS)
    every other op (elementwise,       : 1 flop per output element;
      reductions, casts, copies)         operands + output bytes
    collectives                        : output-shape bytes by kind, plus
                                          operands + output in ``bytes``

Collectives are counted at the port's seam (``dist._collectives``:
``ppermute`` -> collective-permute, ``all_gather`` -> all-gather, ``psum``
-> all-reduce; reduce-scatter and all-to-all have no call there and stay
0), per rank, in the bytes of the collective's output.  These are the
reference's bytes, not the bytes the thread communicator copies
(``_collectives.stats``): a psum of g ranks counts its output once here.
The communicator's own copies and adds are the link's work and are not
counted as ops.

Where the work runs is kept apart: the single controller's ops
(``Counter.cost()``), and each rank's program of a planned product
(``Counter.cost(rank)``), counted in the rank threads ``Mesh.run`` starts
(the counter follows the program there, as it follows autograd's own
thread through the dispatch-mode state autograd carries) or, with
``one_rank=True``, by running rank 0's program alone with a communicator
that moves nothing (``dist._collectives.SoloCommunicator``): the same ops
at the cost of one rank, which is how a (16, 16) mesh is priced.  The
controller's cuts of a global operand into rank blocks and joins of the
blocks (``plan.lower_dist.scatter`` / ``gather``) are the single
controller's layout, not work of a rank's program: they are not counted.

No loop multipliers are needed: eager code runs every trip, the SSD chunk
loop and the sLSTM time loop included.  Two differences from the
reference's count, both deliberate:

* the reference keeps loop-invariant operands smaller than a TPU v5e's
  VMEM (``VMEM_RESIDENT_BYTES``) on chip across the trips of a loop; that
  is a TPU rule with no counterpart here, so this is the reference's
  "naive" count;
* eager bytes are unfused bytes: every op reads its operands from and
  writes its output to device memory, so the byte count runs above XLA's,
  which counts a fusion's operands and output once.

``Counter`` also tracks the live bytes of the tensors the counted ops
allocate (a weak reference on each new storage), per rank, so a dry run
reads a peak beside the arguments it was handed.

A caller may declare a storage the controller holds split over a number
of model-axis shards (``split_over_model``: the dry run's head- and
vocab-parallel tensors, as the reference's GSPMD places them).  Then a
controller op that reads a split storage is that many shards' work: it is
counted apart (``Counter.split_cost``, per shard), and its new outputs are
split alike (``keep`` names a dim size an output must have to stay split,
so a product that contracts the split dim away returns a whole tensor).
Their live bytes count per shard (``split_peak_bytes``).  Without a split
storage, nothing of this runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from repro_torch.device import is_fake

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the reference's names for the port's seam calls
SEAM_KINDS = {"ppermute": "collective-permute", "all_gather": "all-gather",
              "psum": "all-reduce"}
K1_OP = "repro_torch::zorder_matmul"
K2_OP = "repro_torch::flash_attention"
D1_OP = "repro_torch::decode_attention"

# dot ops -> position of the left operand, whose last dim is contracted
_DOTS = {"aten::mm": 1, "aten::bmm": 1, "aten::dot": 1, "aten::mv": 1,
         "aten::addmm": 2, "aten::baddbmm": 2, "aten::addmv": 2}
_GATHERS = {"aten::embedding", "aten::index_select", "aten::gather", "aten::index",
            "aten::take"}
# functional and in-place slice writes: op -> position of the update operand
_SLAB_WRITES = {"aten::index_put_": 2, "aten::index_put": 2, "aten::_index_put_impl_": 2,
                "aten::index_copy_": 3, "aten::index_copy": 3, "aten::slice_scatter": 1,
                "aten::select_scatter": 1, "aten::scatter_": 3, "aten::scatter": 3}
# allocations and metadata (views are free by their schema; prim:: ops too)
_FREE = {"aten::empty", "aten::empty_strided", "aten::new_empty", "aten::new_empty_strided",
         "aten::empty_like", "aten::detach", "aten::lift_fresh", "aten::set_",
         "aten::resize_", "aten::_local_scalar_dense", "aten::arange"}


def _shape_elems_bytes(shape, dtype: torch.dtype) -> Tuple[int, int]:
    """(elements, bytes) of an array of ``shape`` and ``dtype``: the
    reference's helper of that name, on a shape and a type instead of HLO
    text."""
    n = 1
    for d in shape:
        n *= int(d)
    return n, n * dtype.itemsize


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.bytes += o.bytes
        for k in COLLECTIVES:
            self.coll[k] += o.coll[k]
        return self

    def scaled(self, m: float) -> "Cost":
        return Cost(self.flops * m, self.bytes * m, {k: v * m for k, v in self.coll.items()})

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: query i and key j both
    counted from 0 (K2's alignment, and the reference kernel's), j <= i
    when causal, j > i - window when window > 0."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, i + 1) if causal else np.full(sq, skv, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def matmul_cost(m: int, k: int, n: int, dtype: torch.dtype,
                out_dtype: Optional[torch.dtype] = None) -> Cost:
    """K1's cost: 2 m n k flops; A and B read once, C written once."""
    out_dtype = out_dtype or dtype
    return Cost(2.0 * m * n * k, float((m * k + k * n) * dtype.itemsize
                                       + m * n * out_dtype.itemsize))


def flash_cost(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, causal: bool,
               window: int, dtype: torch.dtype) -> Cost:
    """K2's cost: 4 D flops per valid (query, key) pair and query head (QKᵀ
    and PV, 2 each); Q, K, V read once and O written once."""
    return Cost(4.0 * d * b * hq * attention_pairs(sq, skv, causal, window),
                float(2 * b * d * (sq * hq + skv * hkv) * dtype.itemsize))


def decode_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qpos: torch.Tensor,
                kpos: torch.Tensor, window: int, causal: bool) -> Cost:
    """D1's cost for q (B, 1, Hkv, G, Dk), k (B, S, Hkv, Dk), v (B, S, Hkv,
    Dv): 2 (Dk + Dv) flops per valid slot and query head (QKᵀ and PV); Q
    read once, each row's valid slots of K and V once (a row with no valid
    key reads all S slots of V, their mean), O written once.  A slot is
    valid as ``_sdpa``'s mask says (``kpos >= 0``; ``kpos <= qpos`` when
    causal; ``kpos > qpos - window`` when ``window > 0``); on fake
    positions (a dry run) every slot counts."""
    b, _, hkv, g, dk = q.shape
    s, dv = k.shape[1], v.shape[-1]
    if is_fake(qpos) or is_fake(kpos):
        valid = np.full(b, s, dtype=np.int64)
    else:
        qp, kp = qpos.reshape(-1, 1).to(torch.int64), kpos.reshape(-1, s).to(torch.int64)
        ok = kp >= 0
        if causal:
            ok = ok & (kp <= qp)
        if window > 0:
            ok = ok & (kp > qp - window)
        valid = np.broadcast_to(ok.sum(-1).cpu().numpy(), (b,))
    slots = int(valid.sum())
    empty = int((valid == 0).sum())
    item = v.dtype.itemsize
    return Cost(2.0 * (dk + dv) * hkv * g * slots,
                float(item * (b * hkv * g * (dk + dv) + hkv * (slots * (dk + dv)
                                                                + empty * s * dv))))


# -- per-op rules ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rule(func) -> Tuple[str, bool]:
    """(kind, allocates): the op's counting rule, and whether its outputs
    are new storages (no output aliases an input)."""
    name = func._schema.name
    allocates = all(r.alias_info is None for r in func._schema.returns)
    if name in _FREE or name.startswith("prim::") or getattr(func, "is_view", False):
        return "free", allocates
    if name == K1_OP:
        return "k1", allocates
    if name == K2_OP:
        return "k2", allocates
    if name == D1_OP:
        return "d1", allocates
    if name in _DOTS:
        return "dot", allocates
    if name in _GATHERS:
        return "gather", allocates
    if name in _SLAB_WRITES:
        return "slab", allocates
    if name == "aten::copy_":
        return "copy_", allocates
    return "generic", allocates


def _tensors(xs) -> List[torch.Tensor]:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def op_cost(func, args, kwargs, out) -> Cost:
    """The cost of one call of ``func`` (module docstring's table)."""
    kind, _ = _rule(func)
    if kind == "free":
        return Cost()
    outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
    out_e = sum(t.numel() for t in outs)
    out_b = sum(_tensor_bytes(t) for t in outs)
    ins = _tensors(tuple(args) + tuple(kwargs.values()))
    in_b = sum(_tensor_bytes(t) for t in ins)
    if kind == "k1":
        a, b = args[0], args[1]
        return matmul_cost(a.shape[0], a.shape[1], b.shape[1], a.dtype, outs[0].dtype)
    if kind == "k2":
        q, k = args[0], args[1]
        bsz, sq, hq, d = q.shape
        return flash_cost(bsz, sq, k.shape[1], hq, k.shape[2], d, bool(args[3]),
                          int(args[4]), q.dtype)
    if kind == "d1":
        return decode_cost(*args[:5], int(args[5]), bool(args[7]))
    if kind == "dot":
        lhs = args[_DOTS[func._schema.name] - 1]
        return Cost(2.0 * out_e * lhs.shape[-1], float(in_b + out_b))
    if kind == "gather":
        return Cost(float(out_e), 2.0 * out_b)
    if kind == "slab":
        upd = args[_SLAB_WRITES[func._schema.name]] if len(args) > _SLAB_WRITES[
            func._schema.name] else kwargs.get("values", kwargs.get("src"))
        return Cost(0.0, 2.0 * _tensor_bytes(upd) if isinstance(upd, torch.Tensor) else 0.0)
    if kind == "copy_":
        dst, src = args[0], args[1]
        if dst.numel() * dst.element_size() < dst.untyped_storage().nbytes():
            return Cost(0.0, 2.0 * _tensor_bytes(dst))   # a slice write
        return Cost(float(dst.numel()), float(_tensor_bytes(src) + _tensor_bytes(dst)))
    return Cost(float(out_e), float(in_b + out_b))


def _op_key(func, out) -> str:
    t = out[0] if isinstance(out, (list, tuple)) and out else out
    shape = (f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
             if isinstance(t, torch.Tensor) else "")
    return f"{func._schema.name} {shape}"


# -- the counter ---------------------------------------------------------------------


class Counter:
    """What ``counting()`` accumulates (module docstring): a ``Cost`` for
    the controller (rank ``None``) and one for each rank program, the cost
    by op name and by (op, output shape), and live and peak bytes of the
    counted ops' allocations per rank.  ``one_rank``: planned products are
    priced by rank 0's program alone (``plan.lower_dist.spmd``)."""

    def __init__(self, one_rank: bool = False):
        self.one_rank = one_rank
        self.costs: Dict[Optional[int], Cost] = {None: Cost()}
        self.by_op: Dict[str, Cost] = {}
        self.calls: Dict[str, int] = {}
        self.shapes: Dict[str, float] = {}
        self.live: Dict[Optional[int], int] = {}
        self.peak: Dict[Optional[int], int] = {}
        # the controller's work on split storages: whole, by shard count;
        # per shard, by op name
        self.splits: Dict[int, Cost] = {}
        self.split_by_op: Dict[str, Cost] = {}
        self._split_live = 0.0
        self._split_peak = 0.0
        self._storages: Dict[int, _Storage] = {}
        self._any_split = False
        self._memo: Dict = {}
        self._lock = threading.RLock()

    def cost(self, rank: Optional[int] = None) -> Cost:
        """The controller's cost (``rank=None``; without its split work)
        or rank ``rank``'s program's."""
        return self.costs.get(rank, Cost())

    def split_cost(self) -> Cost:
        """The controller's work on split storages, per model-axis shard."""
        total = Cost()
        for n, c in self.splits.items():
            total += c.scaled(1.0 / n)
        return total

    def split_whole(self) -> Cost:
        """The same work whole (as one device runs it)."""
        total = Cost()
        for c in self.splits.values():
            total += c
        return total

    def split_peak_bytes(self) -> int:
        """The controller's live bytes at their peak, each split storage's
        per shard."""
        return int(self._split_peak)

    @property
    def ranks(self) -> List[int]:
        return sorted(r for r in self.costs if r is not None)

    def program(self) -> Cost:
        """The program as one device runs it: the controller's ops plus
        the lowest rank's program (all ranks run the same program)."""
        total = Cost()
        total += self.cost(None)
        total += self.split_whole()
        if self.ranks:
            total += self.cost(self.ranks[0])
        return total

    def peak_bytes(self, rank: Optional[int] = None) -> int:
        return self.peak.get(rank, 0)

    def _add(self, rank, key: str, name: str, c: Cost, shards: int = 1) -> None:
        with self._lock:
            if shards > 1:
                self.splits.setdefault(shards, Cost()).__iadd__(c)
                self.split_by_op.setdefault(name, Cost()).__iadd__(c.scaled(1.0 / shards))
            else:
                self.costs.setdefault(rank, Cost()).__iadd__(c)
            self.by_op.setdefault(name, Cost()).__iadd__(c)
            self.calls[name] = self.calls.get(name, 0) + 1
            self.shapes[key] = self.shapes.get(key, 0.0) + c.bytes

    def memoised(self, key, run: Callable):
        """``run()``'s result, counting its ops once per ``key``: a later
        call with the same key adds what the first one counted (a planned
        product of one plan and shapes costs the same every time)."""
        hit = self._memo.get(key)
        if hit is not None:
            delta, result = hit
            with self._lock:
                for rank, c in delta[0].items():
                    self.costs.setdefault(rank, Cost()).__iadd__(c)
                for name, c in delta[1].items():
                    self.by_op.setdefault(name, Cost()).__iadd__(c)
                for name, n in delta[2].items():
                    self.calls[name] = self.calls.get(name, 0) + n
                for k, b in delta[3].items():
                    self.shapes[k] = self.shapes.get(k, 0.0) + b
            return result
        before = self._snapshot()
        result = run()
        after = self._snapshot()
        self._memo[key] = (tuple({k: _minus(v, b.get(k)) for k, v in a.items()}
                                 for a, b in zip(after, before)), result)
        return result

    def _snapshot(self):
        with self._lock:
            return ({r: c.scaled(1.0) for r, c in self.costs.items()},
                    {n: c.scaled(1.0) for n, c in self.by_op.items()},
                    dict(self.calls), dict(self.shapes))

    def _collective(self, rank, kind: str, out_bytes: int, in_bytes: int, shape: str) -> None:
        c = Cost(0.0, float(out_bytes + in_bytes))
        c.coll[kind] += out_bytes
        self._add(rank, f"COLL:{kind} {shape}", f"COLL:{kind}", c)

    def _entry(self, st) -> "_Storage":
        """The record of storage ``st``, made on first sight with a weak
        reference that drops it (and its live bytes) when ``st`` dies."""
        key = st._cdata
        e = self._storages.get(key)
        if e is None:
            e = self._storages[key] = _Storage(st.nbytes())
            weakref.finalize(st, self._gone, key)
        return e

    def _track(self, rank, outs, split: Tuple[int, Optional[int]] = (1, None)) -> None:
        for t in outs:
            st = t.untyped_storage()
            with self._lock:
                if st._cdata in self._storages and self._storages[st._cdata].tracked:
                    continue
                e = self._entry(st)
                if split[0] > 1 and (split[1] is None or split[1] in t.shape):
                    e.shards, e.keep = split
                if e.nbytes == 0:
                    continue
                e.tracked, e.rank = True, rank
                live = self.live[rank] = self.live.get(rank, 0) + e.nbytes
                if live > self.peak.get(rank, 0):
                    self.peak[rank] = live
                if rank is None:
                    self._split_moved(e.nbytes / e.shards)

    def _split_moved(self, delta: float) -> None:
        self._split_live += delta
        if self._split_live > self._split_peak:
            self._split_peak = self._split_live

    def _gone(self, key) -> None:
        with self._lock:
            e = self._storages.pop(key, None)
            if e is not None and e.tracked:
                self.live[e.rank] = self.live.get(e.rank, 0) - e.nbytes
                if e.rank is None:
                    self._split_live -= e.nbytes / e.shards

    def split_over_model(self, tensors, shards: int, keep: Optional[int] = None) -> None:
        """Declare each tensor's storage split over ``shards`` model-axis
        shards (module docstring); ``keep``: the dim size an op's output
        must have to stay split (None: every output stays split)."""
        if shards <= 1:
            return
        with self._lock:
            self._any_split = True
            for t in tensors:
                e = self._entry(t.untyped_storage())
                if e.tracked and e.rank is None:
                    self._split_moved(e.nbytes / shards - e.nbytes / e.shards)
                e.shards, e.keep = shards, keep

    def _split_of(self, ins) -> Tuple[int, Optional[int]]:
        """(shards, keep) of the most split storage among ``ins``."""
        best = (1, None)
        with self._lock:
            for t in ins:
                e = self._storages.get(t.untyped_storage()._cdata)
                if e is not None and e.shards > best[0]:
                    best = (e.shards, e.keep)
        return best


@dataclasses.dataclass
class _Storage:
    """A storage the counter has seen: its bytes, whether they are live
    bytes of ``rank`` (allocated by a counted op), and the model-axis split
    it was declared or inherited (``Counter.split_over_model``)."""

    nbytes: int
    tracked: bool = False
    rank: Optional[int] = None
    shards: int = 1
    keep: Optional[int] = None


def _minus(a, b):
    if b is None:
        return a
    if isinstance(a, Cost):
        return Cost(a.flops - b.flops, a.bytes - b.bytes,
                    {k: a.coll[k] - b.coll[k] for k in COLLECTIVES})
    return a - b


class _CountingMode(TorchDispatchMode):
    """The dispatch mode of one thread: counts each op into ``counter`` as
    ``rank``'s (None: the controller), unless paused."""

    def __init__(self, counter: Counter, rank: Optional[int] = None):
        super().__init__()
        self.counter = counter
        self.rank = rank
        self.pauses = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "profiler":
            # the ranges ``repro_torch.obs`` spans open: no program operation
            return out
        kind, allocates = _rule(func)
        split = (1, None)
        if self.counter._any_split and self.rank is None and not self.pauses:
            split = self.counter._split_of(_tensors(tuple(args) + tuple(kwargs.values())))
        if allocates:
            self.counter._track(self.rank, _tensors(
                out if isinstance(out, (list, tuple)) else (out,)), split)
        if not self.pauses and kind != "free":
            self.counter._add(self.rank, _op_key(func, out), func._schema.name,
                              op_cost(func, args, kwargs, out), split[0])
        return out


def _mode() -> Optional[_CountingMode]:
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, _CountingMode):
            return m
    return None


def current_counter() -> Optional[Counter]:
    """The counter of the calling thread's counting scope, or None."""
    if torch._C._len_torch_dispatch_stack() == 0:
        return None
    m = _mode()
    return None if m is None else m.counter


@contextlib.contextmanager
def counting(counter: Optional[Counter] = None, *, one_rank: bool = False):
    """Count every op run in the scope (and in the rank threads and the
    autograd threads it starts) into a ``Counter``; yields it."""
    counter = counter if counter is not None else Counter(one_rank=one_rank)
    with _CountingMode(counter):
        yield counter


def rank_scope(counter: Counter, rank: int):
    """The mode a rank thread enters to count its program as ``rank``'s."""
    return _CountingMode(counter, rank)


@contextlib.contextmanager
def paused():
    """Within the scope the calling thread's ops are not counted (their
    allocations are still tracked)."""
    m = _mode() if torch._C._len_torch_dispatch_stack() else None
    if m is None:
        yield
        return
    m.pauses += 1
    try:
        yield
    finally:
        m.pauses -= 1


@contextlib.contextmanager
def as_rank(rank: Optional[int]):
    """Within the scope the calling thread's ops count as ``rank``'s
    program (a rank's work the controller runs for it)."""
    m = _mode() if torch._C._len_torch_dispatch_stack() else None
    if m is None:
        yield
        return
    prev, m.rank = m.rank, rank
    try:
        yield
    finally:
        m.rank = prev


@contextlib.contextmanager
def collective(seam_kind: str, x: torch.Tensor, out_numel: int):
    """Count one seam collective of ``x`` with an output of ``out_numel``
    elements, and pause the counting for the communicator's own work."""
    m = _mode() if torch._C._len_torch_dispatch_stack() else None
    if m is None:
        yield
        return
    if not m.pauses:
        esize = x.element_size()
        m.counter._collective(m.rank, SEAM_KINDS[seam_kind], out_numel * esize,
                              x.numel() * esize,
                              f"{str(x.dtype).replace('torch.', '')}{list(x.shape)}")
    m.pauses += 1
    try:
        yield
    finally:
        m.pauses -= 1


def split_over_model(tensors, shards: int, keep: Optional[int] = None) -> None:
    """``Counter.split_over_model`` on the calling thread's counter (a
    no-op outside a counting scope)."""
    counter = current_counter()
    if counter is not None:
        counter.split_over_model(tensors, shards, keep)


def analyze(fn: Callable, *args, **kwargs) -> Cost:
    """The cost of ``fn(*args, **kwargs)`` as one device runs it
    (``Counter.program``)."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.program()


def analyze_by_shape(fn: Callable, *args, top: int = 20, **kwargs):
    """Profile view: (op, output shape) -> total bytes over the run, every
    rank's included; collectives as ``COLL:kind shape``.  A sorted list of
    (key, bytes), as the reference's."""
    with counting() as c:
        fn(*args, **kwargs)
    return sorted(c.shapes.items(), key=lambda kv: -kv[1])[:top]
