"""The port's planner against the JAX package's, on the CPU (no devices).

Both planners take the same duck-typed mesh stand-ins (axis names, shape,
size, devices), as ``tests/test_plan.py`` does.  Every plan field the
lowering reads -- strategy, overlap, grid, axes, axis roles, replication,
pads, the torus program, the tiling, the fingerprint -- must be equal, and
the ranking ``Estimate``'s words and messages equal with its seconds within
relative 1e-12.  The cases are the planner cases of ``tests/test_plan.py``
and ``tests/test_overlap.py`` and a grid over meshes, Llama-3.2-1B's and
h2o-danube-3-4b's projections at M = 4, 64 and 32768, fp32 and bf16.
"""
import dataclasses
import gc
import math
import weakref
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as ref_plan
from repro.dist import api as ref_api
from repro.obs.profile import LinkParams as RefLink
from repro.obs.profile import MachineProfile as RefProfile
from repro_torch import plan as port_plan
from repro_torch.dist import api as port_api
from repro_torch.dist.local import local_matmul
from repro_torch.dist.mesh import Mesh
from repro_torch.obs.profile import LinkParams, MachineProfile, default_profile

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (k, n) of the distinct projections: Llama-3.2-1B (q/o, k/v, gate/up, down),
# h2o-danube-3-4b (q/o, k/v, gate/up, down)
LLAMA_KN = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
DANUBE_KN = [(3840, 3840), (3840, 960), (3840, 10240), (10240, 3840)]
MS = (4, 64, 32768)
MESHES = [(1,), (4,), (2, 2), (2, 4), (4, 4), (2, 2, 2)]
SECONDS_RTOL = 1e-12


def _names(sizes):
    return {1: ("t",), 2: ("x", "y"), 3: ("pod", "x", "y")}[len(sizes)]


def fake_mesh(sizes, names):
    """Planner-facing mesh stand-in (no devices backing it)."""
    total = math.prod(sizes)
    return SimpleNamespace(
        axis_names=tuple(names), shape=dict(zip(names, sizes)), size=total,
        devices=np.array([SimpleNamespace(id=i, platform="cpu") for i in range(total)]))


@pytest.fixture(autouse=True)
def _clear_port_cache():
    port_plan.cache_clear()
    yield


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _estimate_fields(e):
    if e is None:
        return None
    return {"strategy": e.strategy, "mnk": (e.m, e.n, e.k), "tp": e.tp,
            "comm_bytes": e.comm_bytes, "overlapped": e.overlapped, "msgs": e.msgs,
            "comm_by_axis": tuple(e.comm_by_axis),
            "tree_level_words": tuple(e.tree_level_words)}


def _seconds(e):
    return None if e is None else (e.compute_s, e.comm_s, e.total_s)


def plan_fields(p):
    """Everything of a plan the lowering and the ranking read."""
    sched = p.schedule
    return {
        "strategy": p.strategy, "overlap": p.overlap, "mnk": (p.m, p.n, p.k),
        "batch": tuple(p.batch), "out_dtype": _dtype_name(p.out_dtype),
        "grid": tuple(p.grid), "axes": tuple(p.axes), "axis_roles": tuple(p.axis_roles),
        "replication": p.replication, "pad_a": tuple(p.pad_a), "pad_b": tuple(p.pad_b),
        "schedule": None if sched is None else (sched.q, sched.t, sched.M, sched.anchor),
        "torus": None if p.torus is None else dataclasses.asdict(p.torus),
        "tiling": (p.tiling.order, p.tiling.block_m, p.tiling.block_n, p.tiling.block_k),
        "mesh_fp": p.mesh_fp, "cost": _estimate_fields(p.cost),
    }


def assert_same_plan(port, ref):
    assert plan_fields(port) == plan_fields(ref)
    for a, b in zip(_seconds(port.cost) or (), _seconds(ref.cost) or ()):
        assert a == pytest.approx(b, rel=SECONDS_RTOL, abs=0.0)


def both(m, n, k, *, dtype="float32", out=None, **kw):
    """The same ``build_plan`` call on both packages: (port, reference)."""
    tdt, jdt = DTYPES[dtype]
    tout = DTYPES[out][0] if out else None
    jout = DTYPES[out][1] if out else None
    return (port_plan.build_plan(m, n, k, a_dtype=tdt, b_dtype=tdt, out_dtype=tout, **kw),
            ref_plan.build_plan(m, n, k, a_dtype=jdt, b_dtype=jdt, out_dtype=jout, **kw))


# -- the planner cases of tests/test_plan.py and tests/test_overlap.py --------------

CASES = {
    "cannon_3x3": dict(args=(30, 30, 30), sizes=(3, 3), kw=dict(strategy="cannon")),
    "cannon25d": dict(args=(64, 64, 64), sizes=(2, 2, 2), kw=dict(strategy="cannon25d")),
    "pod25d": dict(args=(64, 64, 64), sizes=(2, 2, 2), kw=dict(strategy="pod25d")),
    "ring_flattens_axes": dict(args=(64, 64, 64), sizes=(2, 2), kw=dict(strategy="ring_ag")),
    "cache_base": dict(args=(128, 128, 128), sizes=(2, 2), kw=dict(strategy="cannon")),
    "cache_k": dict(args=(128, 128, 256), sizes=(2, 2), kw=dict(strategy="cannon")),
    "cache_bf16": dict(args=(128, 128, 128), sizes=(2, 2),
                       kw=dict(strategy="cannon", dtype="bfloat16")),
    "cache_out_bf16": dict(args=(128, 128, 128), sizes=(2, 2),
                           kw=dict(strategy="cannon", out="bfloat16")),
    "cache_summa": dict(args=(128, 128, 128), sizes=(2, 2), kw=dict(strategy="summa")),
    "cache_batch": dict(args=(128, 128, 128), sizes=(2, 2), kw=dict(strategy="cannon",
                                                                    batch=(8,))),
    "summa_2x4": dict(args=(64, 64, 64), sizes=(2, 4), kw=dict(strategy="summa")),
    "summa_2x4_staged": dict(args=(64, 64, 64), sizes=(2, 4),
                             kw=dict(strategy="summa", overlap=False)),
    "cannon_4x4_default_overlap": dict(args=(256, 256, 256), sizes=(4, 4),
                                       kw=dict(strategy="cannon")),
    "ring_ag_1d": dict(args=(64, 64, 64), sizes=(4,), kw=dict(strategy="ring_ag")),
    "pod25d_slab_1d": dict(args=(64, 64, 64), sizes=(2,), names=("pod",),
                           kw=dict(strategy="pod25d", axes=("pod",))),
    "ranked_huge_k": dict(args=(256, 256, 1 << 16), sizes=(2, 2), kw={}),
    "ranked_square": dict(args=(4096, 4096, 4096), sizes=(2, 2), kw={}),
    "ranked_ring_ag": dict(args=(64, 1024, 64), sizes=(4,), kw={}),
    "ranked_ring_rs": dict(args=(64, 64, 1024), sizes=(4,), kw={}),
    "local_no_mesh": dict(args=(48, 16, 32), sizes=None, kw={}),
    "custom_axes_summa": dict(args=(48, 40, 32), sizes=(2, 4),
                              kw=dict(strategy="summa", axes=("y", "x"))),
    "fattree_2x2x2": dict(args=(48, 40, 32), sizes=(2, 2, 2), names=("tree", "x", "y"),
                          kw=dict(strategy="fattree")),
}
for _s, _sizes, _nm in (("cannon", (3, 3), ("x", "y")), ("cannon", (4, 4), ("x", "y")),
                           ("summa", (2, 4), ("x", "y")), ("summa", (4, 4), ("x", "y")),
                           ("cannon25d", (2, 2, 2), ("pod", "x", "y")),
                           ("pod25d", (2, 2, 2), ("pod", "x", "y"))):
    for _ov in (False, True):
        CASES[f"twin_{_s}_{'x'.join(map(str, _sizes))}_{'ov' if _ov else 'staged'}"] = dict(
            args=(24, 24, 24), sizes=_sizes, names=_nm,
            kw=dict(strategy=_s, axes=_nm, overlap=_ov))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_fields_match_reference(case):
    c = CASES[case]
    mesh = None
    if c["sizes"] is not None:
        mesh = fake_mesh(c["sizes"], c.get("names") or _names(c["sizes"]))
    port, ref = both(*c["args"], mesh=mesh, **c["kw"])
    assert_same_plan(port, ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_plan_grid_matches_reference(sizes, dtype):
    """Ranked plans and every mesh candidate (default, staged and
    overlapped variants where the lowering has them) at the serving and
    prefill shapes; ``mesh_candidates``, ``choose`` and the rank order."""
    mesh = fake_mesh(sizes, _names(sizes))
    cands = port_plan.mesh_candidates(mesh)
    assert cands == ref_plan.mesh_candidates(mesh)
    esize = torch.empty((), dtype=DTYPES[dtype][0]).element_size()
    checked = 0
    for m in MS:
        for (k, n) in LLAMA_KN + DANUBE_KN:
            port, ref = both(m, n, k, dtype=dtype, mesh=mesh, use_cache=False)
            assert_same_plan(port, ref)
            if mesh.size > 1:
                pr = port_plan.rank_mesh_strategies(m, n, k, mesh, esize)
                rr = ref_plan.rank_mesh_strategies(m, n, k, mesh, esize)
                assert [_estimate_fields(e) for e in pr] == [_estimate_fields(e) for e in rr]
            assert port_api.choose(m, n, k, mesh=mesh, dtype_bytes=esize) == \
                ref_api.choose(m, n, k, mesh=mesh, dtype_bytes=esize)
            assert port_api.choose(m, n, k, tp=mesh.size, dtype_bytes=esize) == \
                ref_api.choose(m, n, k, tp=mesh.size, dtype_bytes=esize)
            for s in cands:
                if s == "local":
                    continue
                for ov in (None, False, True):
                    try:
                        rp = ref_plan.build_plan(m, n, k, mesh=mesh, strategy=s, overlap=ov,
                                                 a_dtype=DTYPES[dtype][1],
                                                 b_dtype=DTYPES[dtype][1], use_cache=False)
                    except ValueError as e:
                        with pytest.raises(ValueError, match=str(e).split(" (")[0][:30]):
                            port_plan.build_plan(m, n, k, mesh=mesh, strategy=s, overlap=ov,
                                                 a_dtype=DTYPES[dtype][0],
                                                 b_dtype=DTYPES[dtype][0], use_cache=False)
                        continue
                    pp = port_plan.build_plan(m, n, k, mesh=mesh, strategy=s, overlap=ov,
                                              a_dtype=DTYPES[dtype][0],
                                              b_dtype=DTYPES[dtype][0], use_cache=False)
                    assert_same_plan(pp, rp)
                    checked += 1
    assert checked > 0 or mesh.size == 1


# -- estimates, profiles, overlap resolution ---------------------------------------


@pytest.mark.parametrize("strategy", ["cannon", "summa", "cannon25d", "pod25d", "fattree",
                                      "ring_ag", "ring_rs", "xla_ag", "xla_rs", "local"])
@pytest.mark.parametrize("tp", [1, 4, 8, 16])
def test_estimate_matches_reference(strategy, tp):
    for (m, n, k) in ((4096, 4096, 4096), (4, 512, 2048), (32768, 10240, 3840)):
        for ov in (None, False):
            if ov is None or strategy not in ("ring_ag", "ring_rs"):
                pe = port_api.estimate(strategy, m, n, k, tp, 2, overlap=ov)
                re = ref_api.estimate(strategy, m, n, k, tp, 2, overlap=ov)
                assert _estimate_fields(pe) == _estimate_fields(re)
                assert _seconds(pe) == pytest.approx(_seconds(re), rel=SECONDS_RTOL)
    assert port_api.applicable_strategies(tp) == ref_api.applicable_strategies(tp)
    for grid in ((4,), (2, 2, 2), None):
        assert port_api.overlap_capability(strategy, grid) == \
            ref_api.overlap_capability(strategy, grid)


def _profiles():
    """(port, reference) profile pairs: a latency-dominated synthetic one
    (the summa/cannon flip of test_overlap.py) and per-axis link classes."""
    lat = dict(platform="synth", peak_flops=2.86e9)
    axis = dict(platform="synth", peak_flops=1e18)
    return {
        "latency": (MachineProfile(links=(("ici", LinkParams(1.0, 1e18)),), **lat),
                    RefProfile(links=(("ici", RefLink(1.0, 1e18)),), **lat)),
        "per_axis": (MachineProfile(links=(("axis:x", LinkParams(0.0, 1e9)),
                                           ("axis:y", LinkParams(0.0, 1e12)),
                                           ("ici", LinkParams(0.0, 1e12))), **axis),
                     RefProfile(links=(("axis:x", RefLink(0.0, 1e9)),
                                       ("axis:y", RefLink(0.0, 1e12)),
                                       ("ici", RefLink(0.0, 1e12))), **axis)),
    }


@pytest.mark.parametrize("which", ["latency", "per_axis"])
def test_profile_ranking_and_plans_match_reference(which):
    prof, rprof = _profiles()[which]
    for sizes, shape in (((4, 4), (4096, 4096, 4096)), ((2, 4), (8192, 64, 1024)),
                         ((2, 2, 2), (512, 512, 512))):
        mesh = fake_mesh(sizes, _names(sizes))
        m, n, k = shape
        pr = port_plan.rank_mesh_strategies(m, n, k, mesh, profile=prof)
        rr = ref_plan.rank_mesh_strategies(m, n, k, mesh, profile=rprof)
        assert [e.strategy for e in pr] == [e.strategy for e in rr]
        for pe, re in zip(pr, rr):
            assert prof.seconds(pe) == pytest.approx(rprof.seconds(re), rel=SECONDS_RTOL)
        port, ref = both(m, n, k, mesh=mesh, profile=prof, use_cache=False)
        rref = ref_plan.build_plan(m, n, k, mesh=mesh, profile=rprof, use_cache=False)
        assert plan_fields(port) == plan_fields(rref)
    assert default_profile().peak_flops == 197e12     # the reference's analytic constant


def test_latency_profile_flips_cannon_and_summa():
    """test_overlap.py's pin: on a latency-dominated 4x4 machine summa's 6
    rounds beat cannon's 8 only because summa's chain lowering prices as
    overlapped."""
    prof = _profiles()["latency"][0]
    ranked = port_plan.rank_mesh_strategies(4096, 4096, 4096, fake_mesh((4, 4), ("x", "y")),
                                            profile=prof)
    assert ranked[0].strategy == "summa"
    by = {e.strategy: e for e in ranked}
    staged = dataclasses.replace(by["summa"], overlapped=False)
    assert prof.seconds(staged) > prof.seconds(by["cannon"]) > prof.seconds(by["summa"])


@pytest.mark.parametrize("call, match", [
    (dict(mesh=None, overlap=True), "no overlapped lowering"),
    (dict(sizes=(4,), strategy="ring_ag", overlap=False), "intrinsically overlapped"),
    (dict(sizes=(4,), names=("pod",), strategy="pod25d", axes=("pod",), overlap=True),
     "no overlapped lowering"),
    (dict(sizes=(2, 2), strategy="xla_ag"), "cannot plan strategy"),
    (dict(sizes=(4,), strategy="cannon"), "needs a mesh with >= 2 axes"),
    (dict(sizes=(2, 4), strategy="cannon"), "do not span"),
    (dict(sizes=(3, 2, 2), names=("tree", "x", "y"), strategy="fattree"), "power-of-two"),
])
def test_rejections_match_reference(call, match):
    call = dict(call)
    sizes = call.pop("sizes", None)
    names = call.pop("names", None)
    mesh = call.pop("mesh", None) if sizes is None else fake_mesh(sizes, names or _names(sizes))
    for build in (port_plan.build_plan, ref_plan.build_plan):
        with pytest.raises(ValueError, match=match):
            build(64, 64, 64, mesh=mesh, **call)


def test_tuning_waits_for_its_slice():
    """The tuning slice is in: ``build_plan`` and ``planned_matmuls`` take a
    table (held against the reference in ``tests/test_torch_tune.py``)."""
    from repro_torch.tune import TunedBlocks, TuningTable

    mesh = fake_mesh((2, 2), ("x", "y"))
    table = TuningTable(device_kind="cpu").with_entry(
        32, 32, 32, "float32", TunedBlocks(16, 64, 32, "rowmajor", 1e-6, (64, 32, 32)))
    plan = port_plan.build_plan(64, 64, 64, mesh=mesh, strategy="cannon", tuning=table)
    assert plan.tiling.tuned and (plan.tiling.block_m, plan.tiling.order) == (16, "rowmajor")
    with port_plan.planned_matmuls(mesh, tuning=table):
        assert port_plan.planned_tuning() is table


# -- cache, fingerprint ------------------------------------------------------------------


def test_plan_cache_hits_and_key_sensitivity():
    """tests/test_plan.py's cache pin, on the port's cache."""
    mesh = fake_mesh((2, 2), ("x", "y"))
    p1 = port_plan.build_plan(128, 128, 128, mesh=mesh, strategy="cannon")
    s = port_plan.cache_stats()
    assert s["misses"] == 1 and s["hits"] == 0
    assert port_plan.build_plan(128, 128, 128, mesh=mesh, strategy="cannon") is p1
    assert port_plan.cache_stats()["hits"] == 1
    port_plan.build_plan(128, 128, 256, mesh=mesh, strategy="cannon")
    port_plan.build_plan(128, 128, 128, mesh=mesh, strategy="cannon", a_dtype=torch.bfloat16)
    port_plan.build_plan(128, 128, 128, mesh=mesh, strategy="cannon", out_dtype=torch.bfloat16)
    port_plan.build_plan(128, 128, 128, mesh=mesh, strategy="summa")
    port_plan.build_plan(128, 128, 128, mesh=fake_mesh((2, 2), ("a", "b")), strategy="cannon")
    port_plan.build_plan(128, 128, 128, mesh=mesh, strategy="cannon", batch=(8,))
    s = port_plan.cache_stats()
    assert s["hits"] == 1 and s["misses"] == 7


def test_overlap_twins_cached_separately():
    """test_overlap.py's pin: staged and overlapped twins are two entries,
    a repeat of the default is a hit."""
    mesh = fake_mesh((2, 4), ("x", "y"))
    plan = port_plan.build_plan(64, 64, 64, mesh=mesh, strategy="summa")
    assert plan.overlap and plan.cost.overlapped == plan.overlap
    staged = port_plan.build_plan(64, 64, 64, mesh=mesh, strategy="summa", overlap=False)
    assert not staged.overlap and not staged.cost.overlapped
    assert port_plan.cache_info()["misses"] == 2
    assert port_plan.build_plan(64, 64, 64, mesh=mesh, strategy="summa") is plan
    assert port_plan.cache_info()["hits"] == 1


def test_mesh_fingerprint_and_memo():
    m1 = fake_mesh((2, 2), ("x", "y"))
    assert port_plan.mesh_fingerprint(m1) == ref_plan.mesh_fingerprint(m1)
    assert port_plan.mesh_fingerprint(m1) != port_plan.mesh_fingerprint(fake_mesh((4,), ("x",)))
    assert port_plan.mesh_fingerprint(None) is None
    # a real port mesh: memoized per object, released with it, and told
    # apart from a mesh of the same shape on another device
    mesh = Mesh((2, 2), device="cpu")
    fp = port_plan.mesh_fingerprint(mesh)
    assert port_plan.mesh_fingerprint(mesh) is fp
    assert fp[:2] == (("x", "y"), (2, 2)) and "cpu" in fp[3]
    assert fp != port_plan.mesh_fingerprint(Mesh((2, 2), device="cpu", rank=0))
    ref = weakref.ref(mesh)
    del mesh
    gc.collect()
    assert ref() is None, "fingerprint memo pinned a dead mesh"


def test_lower_tiling_default_and_override():
    assert port_plan.lower_tiling(port_plan.TilingPlan()) is local_matmul
    assert not port_plan.TilingPlan(order="rowmajor").is_default
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((48, 32), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((32, 16), dtype=np.float32))
    fn = port_plan.lower_tiling(port_plan.TilingPlan(order="rowmajor", block_m=16,
                                                     block_n=64, block_k=32))
    np.testing.assert_allclose(fn(a, b, out_dtype=torch.float32).numpy(), (a @ b).numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not compiled"):
        port_plan.lower_tiling(port_plan.TilingPlan(block_m=48))(a, b, out_dtype=torch.float32)
