"""A run driven on the CPU at smoke sizes, the chip's look skipped: a sound
program comes out correct under each cell's own limits, and with the timed
path broken underneath, ``correct`` comes out false, once for each fault
the cells can have: an answer (a forward's logits) or a served token
altered where it is produced, and a decode step that leaves its state
(the cache) unchanged.  Beside them the control, the plain reference in
float8 in the program's place, told apart from the program at this size.
The faults are judged under the cells' own limits; the gaps are read in
units of the logits' spread, so they mean the same at this size."""
from __future__ import annotations

import copy
import time
from unittest import mock

import pytest
import torch

from portbench import harness, spec

SEED = 2 ** 31 + 99
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def smoke(cell: str, seed: int = SEED) -> harness.Context:
    """The cell at smoke sizes: its driver, checks and limits, with the
    ``smoke`` sizes its configuration, traffic and workload files give
    (a small model of its family, a small traffic of its kind, a small
    bucket)."""
    ctx = harness.load(cell, seed, "cpu")
    ctx.model = {**ctx.config["smoke"], **ctx.workload.get("model", {})}
    ctx.traffic = {**ctx.traffic, **ctx.traffic.get("smoke", {})}
    ctx.workload = {**ctx.workload, **ctx.workload.get("smoke", {})}
    return ctx


def run(ctx: harness.Context) -> dict:
    m = spec.metrics_of(BENCH, ctx.name)
    return harness.run(ctx, m["end_to_end"], m["per_layer"], 0.2, False, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(smoke(cell))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(spec.workload_file(cell)["checks"])
    names = {m["name"] for m in spec.metrics_of(BENCH, cell)["end_to_end"]}
    assert set(res["metrics"]) == names
    assert res["failed"] == 0 and res["attempted"] > 0


def _altered_logits():
    from repro_torch.models import lm

    real = lm.unembed

    def unembed(p, x, vocab):
        out = real(p, x, vocab)
        out[..., -1, :] = out[..., -1, :].flip(-1)
        return out
    return mock.patch.object(lm, "unembed", unembed)


def _altered_tokens():
    from repro_torch.runtime import serve

    real = serve._sample

    def sample(logits, cfg, gen):
        return (real(logits, cfg, gen) + 1) % logits.shape[-1]
    return mock.patch.object(serve, "_sample", sample)


def _cache_unchanged():
    """Every cached attention call writes into a copy of the cache."""
    from repro_torch.layers import blocks

    real = blocks.gqa_attention

    def attention(p, x, cfg, positions, cache=None, pos=None, **kw):
        if cache is not None and x.shape[1] == 1:
            cache = copy.copy(cache)
            cache = {k: v.clone() for k, v in cache.items()}
        return real(p, x, cfg, positions, cache, pos, **kw)
    return mock.patch.object(blocks, "gqa_attention", attention)


FAULTS = {"prefill": {"answer altered": _altered_logits},
          "serve": {"token altered": _altered_tokens, "state unchanged": _cache_unchanged}}
CASES = [(c, f) for c in CELLS for f in FAULTS.get(spec.workload_file(c)["driver"], {})]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_path_is_not_correct(cell, fault):
    with FAULTS[spec.workload_file(cell)["driver"]][fault]():
        res = run(smoke(cell))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_told_apart(cell):
    """The reference in float8 in the program's place reads at least three
    times what the program reads on some number the cell compares, the
    rule its limit on the card is set by (at this size the readings are
    smaller than on the card, and the card's limits do not carry over)."""
    ctx = smoke(cell)
    drv = spec.driver(ctx.workload["driver"]).Driver(ctx)
    drv.setup()
    drv.window(0.0)
    got = drv.check(control=True)
    assert any(got[f"control.{k}"] >= 3 * got[k] for k in ctx.workload["checks"]), got


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_judged_by_the_runs_comparison(cell):
    """``control.py`` holds the control's readings to the limits with the
    comparison a run makes: a reading above its limit is not correct, one
    at or under it is."""
    checks = spec.workload_file(cell)["checks"]
    over = {k: c["limit"] * 1.5 for k, c in checks.items()}
    at = {k: c["limit"] for k, c in checks.items()}
    assert not harness.judge(over, checks)[1]
    assert harness.judge(at, checks)[1]
    assert harness.judge(over, checks)[0] == {k: {"value": over[k], "limit": c["limit"]}
                                              for k, c in checks.items()}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    ctx = smoke(metric["workloads"][0])
    assert spec.metric_reader(metric["name"]).read(ctx) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_smoke_run_on_the_card(card, cell):
    """A traced run at smoke sizes on the card: every per-layer metric of
    the cell read, no share above 100 %, the device busy for some of the
    window."""
    ctx = smoke(cell)
    ctx.device = card
    m = spec.metrics_of(BENCH, cell)
    res = harness.run(ctx, m["end_to_end"], m["per_layer"], 0.5, True, time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {x["name"] for x in m["per_layer"]}
    assert all(v["value"] <= 100.0 for v in res["metrics"].values() if v["unit"] == "%")
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
