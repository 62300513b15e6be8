"""The port's drift check (``repro_torch.verify.drift``) against
``repro.verify.drift``, on the CPU.

* The collective leg runs every drift cell (the reference's ``DRIFT_CELLS``)
  on CPU thread meshes: the obs multiset, the interceptor's and the trace's
  are equal, exactly.
* The ranking leg: ``ranking_drift`` gives the reference's rows for the
  same stored and fresh profiles on fake meshes (margins within relative
  1e-12).
* The tuning leg: with the same fresh winners and re-timed stored seconds
  injected into both packages, ``tuning_drift`` gives the reference's rows.
* ``check_drift`` reports a broken cell instead of raising, and is then
  not ok.
"""
import math
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import repro.tune
from repro.obs.profile import LinkParams as RefLink
from repro.obs.profile import MachineProfile as RefProfile
from repro.tune.table import TunedBlocks as RefBlocks
from repro.tune.table import TuningTable as RefTable
from repro.verify import drift as ref_drift
import repro_torch.tune
from repro_torch import obs
from repro_torch.dist.mesh import Mesh
from repro_torch.obs.profile import LinkParams, MachineProfile
from repro_torch.tune import TunedBlocks, TuningTable
from repro_torch.verify import drift


@pytest.fixture(autouse=True)
def _fresh_recorder():
    obs.disable()
    obs.reset()
    obs.reset_metrics()
    yield
    obs.disable()
    obs.reset()
    obs.reset_metrics()


def fake_mesh(sizes, names):
    total = math.prod(sizes)
    return SimpleNamespace(
        axis_names=tuple(names), shape=dict(zip(names, sizes)), size=total,
        devices=np.array([SimpleNamespace(id=i, platform="cpu") for i in range(total)]))


def test_the_port_drifts_over_the_reference_cells():
    assert drift.DRIFT_CELLS == ref_drift.DRIFT_CELLS
    assert drift.RANKING_SHAPES == ref_drift.RANKING_SHAPES


@pytest.mark.parametrize("strategy, shape, names", drift.DRIFT_CELLS,
                         ids=[c[0] for c in drift.DRIFT_CELLS])
def test_measure_cell_on_a_cpu_thread_mesh(strategy, shape, names):
    mesh = Mesh(shape, names, device="cpu")
    try:
        row = drift.measure_cell(strategy, mesh)
    finally:
        mesh.close()
    assert row["ok"], row
    assert row["collectives"] > 0 and row["error"] == ""
    assert not obs.enabled()


def test_check_drift_collective_leg_on_all_cells_on_the_cpu():
    rep = drift.check_drift(device="cpu")
    assert [c["strategy"] for c in rep["cells"]] == [c[0] for c in drift.DRIFT_CELLS]
    assert all(c["ok"] for c in rep["cells"]), rep["cells"]
    assert rep["ok"] and rep["ranking"] == [] and rep["tuning"] == []
    fresh = rep["fresh_profile"]
    assert fresh["platform"] == "cpu" and {"ici", "axis:x", "axis:y", "local"} <= set(
        fresh["links"])


def test_a_cell_that_loses_its_obs_records_is_not_ok(monkeypatch):
    """The seam's obs hook dropping one kind: obs != interceptor == trace."""
    real = obs.record_collective

    def drop_psum(kind, *a, **kw):
        if kind != "psum":
            real(kind, *a, **kw)

    monkeypatch.setattr(obs, "record_collective", drop_psum)
    mesh = Mesh((2, 2, 2), ("pod", "x", "y"), device="cpu")
    try:
        row = drift.measure_cell("pod25d", mesh)
    finally:
        mesh.close()
    assert not row["ok"] and "multiset divergence" in row["error"]


def test_check_drift_reports_a_broken_cell_and_is_not_ok(monkeypatch):
    real = drift.measure_cell

    def broken(strategy, mesh, *a, **kw):
        if strategy == "summa":
            raise ArithmeticError("summa broke")
        return real(strategy, mesh, *a, **kw)

    monkeypatch.setattr(drift, "measure_cell", broken)
    rep = drift.check_drift(device="cpu")
    bad = [c for c in rep["cells"] if not c["ok"]]
    assert [c["strategy"] for c in bad] == ["summa"]
    assert bad[0]["error"] == "ArithmeticError: summa broke"
    assert not rep["ok"] and len(rep["cells"]) == len(drift.DRIFT_CELLS)


# (stored, fresh): per profile (peak FLOP/s, {link: (alpha_s, bw)})
PROFILE_PAIRS = [
    ((4e14, {"ici": (0.0, 1e11)}), (4e14, {"ici": (0.0, 1e11)})),
    ((1e15, {"ici": (0.0, 4.5e10)}), (1e15, {"ici": (5e-3, 4.5e10)})),
    ((6e14, {"ici": (8e-4, 1e15), "axis:x": (9e-4, 1e15), "axis:y": (7e-4, 1.2e11)}),
     (6.6e14, {"ici": (1e-6, 2e12), "axis:x": (1e-6, 1e12), "axis:y": (2e-6, 3e12)})),
    ((2e12, {"ici": (1e-3, 1e9)}), (9e14, {"ici": (1e-7, 1e13)})),
]


def _profile(cls, link_cls, spec):
    peak, links = spec
    return cls("cpu", peak, tuple(sorted((n, link_cls(*p)) for n, p in links.items())))


@pytest.mark.parametrize("margin", [0.0, 0.1, 10.0])
@pytest.mark.parametrize("pair", range(len(PROFILE_PAIRS)))
@pytest.mark.parametrize("sizes", [(2, 2), (4, 4), (2, 4)])
def test_ranking_drift_equals_the_reference(sizes, pair, margin):
    mesh = fake_mesh(sizes, ("x", "y"))
    stored, fresh = PROFILE_PAIRS[pair]
    got = drift.ranking_drift(mesh, _profile(MachineProfile, LinkParams, stored),
                              _profile(MachineProfile, LinkParams, fresh), flip_margin=margin)
    want = ref_drift.ranking_drift(mesh, _profile(RefProfile, RefLink, stored),
                                   _profile(RefProfile, RefLink, fresh), flip_margin=margin)
    assert len(got) == len(want) == len(drift.RANKING_SHAPES)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "margin"} == \
            {k: v for k, v in w.items() if k != "margin"}
        assert g["margin"] == pytest.approx(w["margin"], rel=1e-12, abs=0)


# per bucket (one both packages key alike): the stored winner and its
# seconds, the fresh winner and its seconds, the stored winner re-timed
TUNING_CASE = [
    ((128, 512, 2048), (16, 64, 64, "zorder"), 6e-6, (16, 64, 64, "zorder"), 6e-6, None),
    ((128, 8192, 2048), (64, 64, 64, "zorder"), 25e-6, (128, 128, 64, "rowmajor"), 18e-6, 25e-6),
    ((256, 512, 512), (128, 128, 64, "zorder"), 7e-6, (16, 64, 128, "rowmajor"), 6.5e-6, 7e-6),
    ((256, 2048, 2048), (128, 128, 64, "zorder"), 14e-6, (128, 256, 64, "zorder"), 15e-6,
     14.5e-6),
    ((1024, 1024, 1024), (128, 128, 64, "zorder"), 1e-5, (128, 256, 64, "zorder"), 9e-6, 1e-5),
]


def _stored_tables():
    port, ref = TuningTable(device_kind="cpu"), RefTable(device_kind="cpu")
    for bucket, blocks, s, *_ in TUNING_CASE:
        port = port.with_entry(*bucket, "bfloat16", TunedBlocks(*blocks, s, bucket))
        ref = ref.with_entry(*bucket, "bfloat16", RefBlocks(*blocks, s, bucket))
    return port, ref


@pytest.mark.parametrize("margin", [0.05, 0.1, 0.5])
@pytest.mark.parametrize("max_entries", [2, 4, 5])
def test_tuning_drift_equals_the_reference(monkeypatch, margin, max_entries):
    """Both packages' searches replaced by the same fresh winners, and the
    stored winners' re-timing by the same seconds: the same rows."""
    fresh = {bucket: (blocks, s) for bucket, _, _, blocks, s, _ in TUNING_CASE}
    retimed = {bucket: t for bucket, _, _, _, _, t in TUNING_CASE}

    def search(cls):
        def tune_shape(m, n, k, dtype="bfloat16", **kw):
            blocks, s = fresh[(m, n, k)]
            return cls(*blocks, s, (m, n, k))
        return tune_shape

    def timer(m, n, k, dtype, cand, **kw):
        return retimed[(m, n, k)]

    monkeypatch.setattr(repro.tune, "tune_shape", search(RefBlocks))
    monkeypatch.setattr(repro.tune, "time_candidate", timer)
    monkeypatch.setattr(repro_torch.tune, "tune_shape", search(TunedBlocks))
    port, ref = _stored_tables()
    got = drift.tuning_drift(port, flip_margin=margin, max_entries=max_entries, timer=timer)
    want = ref_drift.tuning_drift(ref, flip_margin=margin, max_entries=max_entries)
    assert len(got) == len(want) == min(max_entries, len(TUNING_CASE))
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "margin"} == \
            {k: v for k, v in w.items() if k != "margin"}
        assert g["margin"] == pytest.approx(w["margin"], rel=1e-12, abs=1e-15)
    assert any(r["flipped"] for r in got) == (margin < 0.38)


def test_check_drift_with_a_stored_profile_runs_all_three_legs(tmp_path):
    """A stored profile with an embedded table: the ranking rows cover the
    reference's shapes, and the tuning leg re-times with the given timer."""
    table = TuningTable(device_kind="cpu").with_entry(
        16, 512, 2048, "bfloat16", TunedBlocks(64, 64, 64, "rowmajor", 1e-5, (16, 512, 2048)))
    stored = MachineProfile("cpu", 1e12, (("ici", LinkParams(1e-4, 1e10)),), tuning=table)
    path = obs.save_profile(stored, str(tmp_path / "p.json"))

    def timer(m, n, k, dtype, cand):
        return 1e-5 if cand == (64, 64, 64, "rowmajor") else 2e-5

    rep = drift.check_drift(profile_path=path, device="cpu", timer=timer)
    assert [r["shape"] for r in rep["ranking"]] == list(drift.RANKING_SHAPES)
    assert [(r["stored"], r["fresh"], r["flipped"]) for r in rep["tuning"]] == \
        [("64x64x64/rowmajor", "64x64x64/rowmajor", False)]
    assert all(c["ok"] for c in rep["cells"])
    assert rep["ok"] == (not any(r["flipped"] for r in rep["ranking"]))
    assert Counter(type(r["margin"]) for r in rep["ranking"]) == Counter({float: 3})
