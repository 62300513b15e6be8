"""The port's MoE layer against the JAX package's, on the CPU, in fp32.

Parameters are the JAX smoke models' (``params_from_jax``), activations
come from a seeded numpy generator.  The reference's ``moe`` is plain
``jnp`` (no Pallas), so it runs as is.  Tolerances: each output row (the
last dim) within 1e-5 relative L2 of the reference's row; the aux loss
within 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.layers import moe as jmoe
from repro.models.registry import build_model as jax_build_model
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.layers import moe as tmoe
from repro_torch.models.config import PORT_ONLY_FIELDS

TOL = 1e-5
AUX_TOL = 1e-6


def row_rel(port, ref) -> float:
    """Worst row's relative L2 error, rows along the last dim."""
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    p, r = port.reshape(-1, ref.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float(np.max(np.linalg.norm(p - r, axis=1)
                        / np.maximum(np.linalg.norm(r, axis=1), 1e-30)))


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _params(arch: str, dtype: str):
    """(jax, port) MoE params of the smoke model's first MoE layer."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              dataclasses.replace(get_smoke_config(arch), dtype=dtype),
                              device="cpu")
    return (jax.tree.map(lambda a: a[0], jparams["layers"]["moe"]),
            tparams["layers"][0]["moe"])


def _layer(arch: str, **over):
    """(jax cfg, port cfg, jax MoE params, port MoE params) of the smoke
    model's first MoE layer, fp32, with ``over`` replaced in both configs."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32", **over)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **over)
    return (jcfg, tcfg) + _params(arch, "float32")


@pytest.fixture(scope="module", params=["deepseek-moe-16b", "qwen3-moe-30b-a3b"])
def arch(request):
    return request.param


@pytest.mark.parametrize("factor", [1.25, 0.25, 4.0])
@pytest.mark.parametrize("batch, seq", [(2, 64), (3, 32), (2, 8)])
def test_moe_matches_reference(arch, factor, batch, seq):
    """Groups of min(32, S) tokens: two groups a row at S = 64, one at 32,
    one of 8 at S = 8; capacity factor 0.25 forces drops (capacity 4 slots
    for 8 choices an expert on average), 4.0 drops nothing."""
    jcfg, tcfg, jp, tp = _layer(arch, capacity_factor=factor)
    x = _np(0, batch, seq, tcfg.d_model)
    ref, ref_aux = jmoe.moe(jp, jnp.asarray(x), jcfg)
    out, aux = tmoe.moe(tp, torch.from_numpy(x), tcfg)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    assert row_rel(out, ref) < TOL
    assert abs(float(aux) - float(ref_aux)) < AUX_TOL


def test_small_capacity_drops_tokens(arch):
    """The drop is real: at capacity factor 0.25 the output moves away from
    the same layer's at 4.0, on both sides alike."""
    x = _np(1, 2, 64, 64)
    outs = {}
    for factor in (0.25, 4.0):
        jcfg, tcfg, jp, tp = _layer(arch, capacity_factor=factor)
        outs[factor] = (tmoe.moe(tp, torch.from_numpy(x), tcfg)[0],
                        jmoe.moe(jp, jnp.asarray(x), jcfg)[0])
    assert tmoe._capacity(32, 8, 2, 0.25) == 4 and tmoe._capacity(32, 8, 2, 4.0) == 32
    assert row_rel(outs[0.25][0], outs[4.0][0]) > 1e-2
    assert row_rel(outs[0.25][1], outs[4.0][1]) > 1e-2


def test_shared_experts_are_added(arch):
    """deepseek's shared experts: the output minus the shared ``mlp`` is the
    routed part alone (qwen3 has none)."""
    _, tcfg, _, tp = _layer(arch)
    x = torch.from_numpy(_np(2, 2, 32, 64))
    y, _ = tmoe.moe(tp, x, tcfg)
    routed = {k: v for k, v in tp.items() if k != "shared"}
    y_routed, _ = tmoe.moe(routed, x, tcfg)
    if "shared" in tp:
        assert tuple(tp["shared"]["w_gate"].shape) == (64, 48)
        assert not torch.equal(y, y_routed)
    else:
        assert torch.equal(y, y_routed)


@pytest.mark.parametrize("group", [32, 20])
def test_sequence_not_a_multiple_of_the_group_raises_in_both(arch, group):
    """S = 48 against groups of min(group, 48): the reference asserts, the
    port raises ValueError."""
    jcfg, tcfg, jp, tp = _layer(arch, moe_group_size=group)
    x = _np(3, 1, 48, 64)
    with pytest.raises(AssertionError):
        jmoe.moe(jp, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="not a multiple"):
        tmoe.moe(tp, torch.from_numpy(x), tcfg)


@pytest.mark.parametrize("group, e, k, factor", [
    (32, 8, 2, 1.25), (1, 64, 6, 1.25), (16, 64, 6, 1.25), (256, 128, 8, 1.25),
    (7, 3, 1, 0.5)])
def test_capacity_is_the_reference_formula(group, e, k, factor):
    assert tmoe._capacity(group, e, k, factor) == jmoe._capacity(group, e, k, factor)


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal values come out in index order, as ``jax.lax.top_k`` orders them."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 3, size=(5, 7, 16)).astype(np.float32) / 4
    vals, idx = tmoe.top_k(torch.from_numpy(x), 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_exact_router_tie_picks_the_first_experts(arch):
    """A zero router gives every expert the same probability: both packages
    send every token to experts 0..k-1, so the output is the reference's and
    zeroing experts k.. changes nothing."""
    jcfg, tcfg, jp, tp = _layer(arch, capacity_factor=4.0)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _np(5, 2, 32, 64)
    ref, ref_aux = jmoe.moe(jp, jnp.asarray(x), jcfg)
    out, aux = tmoe.moe(tp, torch.from_numpy(x), tcfg)
    assert row_rel(out, ref) < TOL
    k = tcfg.top_k
    assert abs(float(aux) - k) < AUX_TOL and abs(float(ref_aux) - k) < AUX_TOL
    first = dict(tp)
    for name in ("w_gate", "w_up", "w_down"):
        w = tp[name].clone()
        w[k:] = 0
        first[name] = w
    assert torch.equal(tmoe.moe(first, torch.from_numpy(x), tcfg)[0], out)


def test_moe_params_shapes_and_types():
    tcfg = get_smoke_config("deepseek-moe-16b")
    p = tmoe.moe_params(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, "cpu")
    assert p["router"].dtype == torch.float32 and tuple(p["router"].shape) == (64, 8)
    assert tuple(p["w_gate"].shape) == tuple(p["w_up"].shape) == (8, 64, 48)
    assert tuple(p["w_down"].shape) == (8, 48, 64) and p["w_down"].dtype == torch.bfloat16
    assert tuple(p["shared"]["w_down"].shape) == (48, 64)


def test_bf16_moe_matches_reference_loosely(arch):
    """bf16 activations and weights: the expert products' outputs are rounded
    to bf16 on both sides before the fp32 combine, as the reference casts
    them; rows agree to bf16 rounding (a few 2^-8)."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp, tp = _params(arch, "bfloat16")
    x = _np(6, 2, 32, 64)
    ref, ref_aux = jmoe.moe(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    out, aux = tmoe.moe(tp, torch.from_numpy(x).bfloat16(), tcfg)
    assert out.dtype == torch.bfloat16
    assert row_rel(out, np.asarray(ref.astype(jnp.float32))) < 3e-2
    assert abs(float(aux) - float(ref_aux)) < 1e-3


def test_bf16_routed_moe_matches_reference_loosely(arch, monkeypatch):
    """The routed route (``moe_experts.takes`` patched true, the dense
    one-hots made to raise, so the plain version over the pair list
    serves) in bf16 against the reference's bf16 ``moe``, at the dense
    route's limits: the same rounding points, only the fp32 combine's
    summation order differs."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp, tp = _params(arch, "bfloat16")
    x = _np(6, 2, 32, 64)

    def dense(*a):
        raise AssertionError("the dense route ran")

    monkeypatch.setattr(tmoe.moe_experts, "takes", lambda *a: True)
    monkeypatch.setattr(tmoe, "dispatch_combine", dense)
    ref, ref_aux = jmoe.moe(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    out, aux = tmoe.moe(tp, torch.from_numpy(x).bfloat16(), tcfg)
    assert out.dtype == torch.bfloat16
    assert row_rel(out, np.asarray(ref.astype(jnp.float32))) < 3e-2
    assert abs(float(aux) - float(ref_aux)) < 1e-3


# -- the routed route's pair list (kernels/moe_experts) against the dense one-hots ----

def _pad_rows(x):
    """Left padding as a serving batch has it: each row's first tokens the
    same pad embedding, so they route alike and overflow their experts."""
    x = x.copy()
    x[:, :20] = x[:1, :1]
    return x


# name -> (config changes, router zeroed, input, DISPATCH_TOKENS patched)
PAIR_CASES = {
    "overflow": (dict(capacity_factor=0.25), False, lambda: _np(7, 2, 64, 64), None),
    "ties": (dict(), True, lambda: _np(8, 1, 32, 64), None),        # one group
    "pads": (dict(), False, lambda: _pad_rows(_np(9, 3, 32, 64)), None),
    "unrenormalised": (dict(moe_renormalize=False, capacity_factor=4.0), False,
                       lambda: _np(10, 2, 64, 64), None),
    "slices": (dict(capacity_factor=0.5), False, lambda: _np(11, 3, 64, 64), 64),
}


def _pair_case(arch, name, monkeypatch):
    """(jax cfg, port cfg, jax params, port params, x) of a case, fp32,
    DISPATCH_TOKENS patched where the case says; the jax cfg is None where
    the case sets a port-only field (the reference has no such setting)."""
    over, zero_router, make, budget = PAIR_CASES[name]
    jcfg, tcfg, jp, tp = _layer(arch)
    tcfg = dataclasses.replace(tcfg, **over)
    jcfg = (None if set(over) & set(PORT_ONLY_FIELDS)
            else dataclasses.replace(jcfg, **over))
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
        tp = dict(tp, router=torch.zeros_like(tp["router"]))
    if budget is not None:
        monkeypatch.setattr(tmoe, "DISPATCH_TOKENS", budget)
    return jcfg, tcfg, jp, tp, torch.from_numpy(make())


def _slices(cfg, x):
    """The token-group slices ``moe`` routes at once, (N, g, d) each."""
    b, s, d = x.shape
    g = min(cfg.moe_group_size, s)
    xg = x.reshape(b * s // g, g, d)
    step = max(1, tmoe.DISPATCH_TOKENS // g)
    return [xg[i:i + step] for i in range(0, xg.shape[0], step)], g


@pytest.mark.parametrize("name", list(PAIR_CASES))
def test_pair_list_keeps_the_dense_dispatch_choices_slots_and_gates(arch, name, monkeypatch):
    """``pairs`` lists exactly the choices the dense route's one-hot
    ``dispatch`` keeps, each expert's in its slots' order (group by group,
    slot by slot), with the gates ``combine`` holds; every dropped choice
    has place -1 and sorts after offsets[E]; a kept pair's place is its
    index in ``rows``."""
    _, cfg, _, p, x = _pair_case(arch, name, monkeypatch)
    e, k = cfg.num_experts, cfg.top_k
    slices, g = _slices(cfg, x)
    cap = tmoe._capacity(g, e, k, cfg.capacity_factor)
    assert len(slices) == (3 if name == "slices" else 1)
    dropped = 0
    for xg in slices:
        n = xg.shape[0]
        _, gate_vals, expert_idx = tmoe._route(p, xg.float(), cfg)
        dispatch, combine = tmoe.dispatch_combine(expert_idx, gate_vals, e, cap)
        rows, offsets, pos, gates = tmoe.pairs(expert_idx, gate_vals, e, cap)
        assert (rows.dtype, offsets.dtype, pos.dtype, gates.dtype) == (
            torch.int32, torch.int32, torch.int32, torch.float32)
        assert rows.shape == (n * g * k,) and offsets.shape == (e + 1,) and pos.shape == (n * g, k)
        assert torch.equal(gates, gate_vals.reshape(n * g, k))
        kept = int(offsets[-1])
        assert offsets[0] == 0 and bool((offsets[1:] >= offsets[:-1]).all())
        assert kept == int(dispatch.sum())
        dropped += n * g * k - kept
        # rebuild the one-hots from the pair list
        d2, c2 = torch.zeros_like(dispatch), torch.zeros_like(combine)
        for ex in range(e):
            lo, hi = int(offsets[ex]), int(offsets[ex + 1])
            first = {}
            for q in range(lo, hi):
                grp, t = divmod(int(rows[q]), g)
                slot = q - first.setdefault(grp, q)
                assert grp >= max(first) and slot < cap      # group-major, within capacity
                c = [int(v) for v in pos[grp * g + t]].index(q)
                assert int(expert_idx[grp, t, c]) == ex
                d2[grp, t, ex, slot] = 1.0
                c2[grp, t, ex, slot] = gates[grp * g + t, c]
        assert torch.equal(d2, dispatch) and torch.equal(c2, combine)
        placed = pos[pos >= 0]
        assert placed.numel() == kept and placed.unique().numel() == kept
        assert bool((placed < kept).all())
        assert torch.equal(rows[pos[pos >= 0].long()],
                           torch.arange(n * g).repeat_interleave(k)[(pos >= 0).reshape(-1)]
                           .to(torch.int32))
    assert (dropped > 0) == (name in ("overflow", "ties", "pads", "slices"))


@pytest.mark.parametrize("name", list(PAIR_CASES))
def test_routed_plain_version_equals_the_dense_route(arch, name, monkeypatch):
    """The routed route on the CPU (``moe_experts.takes`` patched true, so
    the plain version runs over the pair list) against the reference's
    ``moe`` and the dense route in fp32: outputs within ``TOL`` (only the
    combine's summation order differs), the aux loss within ``AUX_TOL`` of
    the reference's and bitwise the dense route's; each call counted under
    its route in ``layer.moe.calls`` and the plain launches in
    ``kernel.moe_experts.launches``.  ``moe_renormalize`` off is a
    port-only setting: there the dense route is the yardstick alone."""
    from repro_torch import obs

    jcfg, cfg, jp, p, x = _pair_case(arch, name, monkeypatch)
    obs.reset_metrics()
    try:
        with obs.observe():
            dense, dense_aux = tmoe.moe(p, x, cfg)
            monkeypatch.setattr(tmoe.moe_experts, "takes", lambda *a: True)
            routed, routed_aux = tmoe.moe(p, x, cfg)
        snap = obs.snapshot()
    finally:
        obs.reset()
        obs.reset_metrics()
    assert routed.dtype == dense.dtype == torch.float32
    assert row_rel(routed, dense.numpy()) < TOL
    assert torch.equal(routed_aux, dense_aux)
    assert (jcfg is None) == (name == "unrenormalised")
    if jcfg is not None:
        ref, ref_aux = jmoe.moe(jp, jnp.asarray(x.numpy()), jcfg)
        assert row_rel(routed, ref) < TOL
        assert abs(float(routed_aux) - float(ref_aux)) < AUX_TOL
    slices = len(_slices(cfg, x)[0])
    assert snap["layer.moe.calls{route=dense}"] == snap["layer.moe.calls{route=routed}"] == 1
    assert snap["kernel.moe_experts.launches{route=plain}"] == slices


def test_moe_experts_op_fake_implementation_and_refusals():
    """``takes`` refuses CPU tensors, fp32 and every call on fake tensors,
    so the MoE layer on fake tensors (a dry run) runs the dense route: x's
    shape and type, counted ``dense`` in ``layer.moe.calls``, no kernel
    launch; ``tile_for`` takes thin tiles up to ``THIN_MAX_ROWS`` pairs an
    expert."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import obs
    from repro_torch.kernels import moe_experts
    from repro_torch.kernels.moe_experts import kernel as kmoe

    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    args = lambda dt: (torch.zeros(2, 32, d, dtype=dt),  # noqa: E731
                       torch.zeros(e, d, ff, dtype=dt), torch.zeros(e, d, ff, dtype=dt),
                       torch.zeros(e, ff, d, dtype=dt))
    assert not moe_experts.takes(*args(torch.bfloat16))
    assert not moe_experts.takes(*args(torch.float32))
    assert kmoe.tile_for(64 * 6, 64) == "thin" and kmoe.tile_for(32768 * 6, 64) == "wide"
    assert kmoe.tile_for(32 * 64, 64) == "thin" and kmoe.tile_for(32 * 64 + 1, 64) == "wide"
    before = kmoe.launches
    obs.reset_metrics()
    try:
        with obs.observe(), FakeTensorMode():
            x, wg, wu, wd = args(torch.bfloat16)
            assert not moe_experts.takes(x, wg, wu, wd)
            p = {"router": torch.zeros(d, e), "w_gate": wg, "w_up": wu, "w_down": wd}
            out, aux = tmoe.moe(p, x, cfg)
        snap = obs.snapshot()
    finally:
        obs.reset()
        obs.reset_metrics()
    assert out.shape == x.shape and out.dtype == torch.bfloat16 and aux.shape == ()
    assert snap["layer.moe.calls{route=dense}"] == 1
    assert "layer.moe.calls{route=routed}" not in snap
    assert kmoe.launches == before
