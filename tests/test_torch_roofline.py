"""The port's cost counter and roofline terms (``repro_torch.roofline``)
against the reference's HLO analyzer (``repro.roofline``), on the CPU.

Tolerances: dot FLOPs and collective bytes exact; a program's total FLOPs
within 1 % of the reference's count of the same ``jnp`` program (XLA
counts its loop counters and slices of the scanned weights, the port's
loop has neither); ``Roofline`` fields equal.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack, _pop_mode, _push_mode

from repro.configs import get_config as ref_get_config
from repro.core import cost as ref_cost
from repro.roofline import analysis as ref_analysis
from repro.roofline.hlo_stats import _shape_elems_bytes as ref_shape_elems_bytes
from repro.roofline.hlo_stats import analyze as ref_analyze
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.dist import _collectives
from repro_torch.dist.api import symmetric_matmul
from repro_torch.dist.mesh import Mesh
from repro_torch.kernels.flash_attention import attention_ref, mha
from repro_torch.kernels.matmul import matmul
from repro_torch.launch.specs import abstract_params
from repro_torch.plan.lower_dist import P, spmd
from repro_torch.roofline import analysis, hlo_stats
from repro_torch.runtime.serve import decode_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL_TOL = 0.01


def _ref_count(f, *shapes):
    comp = jax.jit(f).lower(*(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)).compile()
    return ref_analyze(comp.as_text())


# -- the reference's scan tests, as Python loops ------------------------------------------


@pytest.mark.parametrize("product", ["torch", "k1"])
def test_scan_flops_counted_every_trip(product):
    L, m, d = 8, 128, 256

    def ref(x, ws):
        def body(x, w):
            return jnp.tanh(x @ w), None
        x, _ = jax.lax.scan(body, x, ws)
        return x

    mm = (lambda a, b: a @ b) if product == "torch" else matmul
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((m, d), dtype=np.float32))
    ws = torch.from_numpy(rng.standard_normal((L, d, d), dtype=np.float32))

    def port(x, ws):
        for i in range(L):
            x = torch.tanh(mm(x, ws[i]))
        return x

    with hlo_stats.counting() as c:
        port(x, ws)
    dot = "aten::mm" if product == "torch" else hlo_stats.K1_OP
    assert c.by_op[dot].flops == 2 * m * d * d * L
    assert c.calls[dot] == L
    want = _ref_count(ref, (m, d), (L, d, d)).flops
    assert abs(c.program().flops - want) / want < TOTAL_TOL


def test_nested_scan():
    def ref(x, ws):
        def outer(x, w):
            def inner(x, _):
                return jnp.tanh(x @ w), None
            x, _ = jax.lax.scan(inner, x, None, length=4)
            return x, None
        x, _ = jax.lax.scan(outer, x, ws)
        return x

    x, ws = torch.randn(64, 64), torch.randn(3, 64, 64)

    def port(x, ws):
        for i in range(3):
            for _ in range(4):
                x = torch.tanh(x @ ws[i])
        return x

    with hlo_stats.counting() as c:
        port(x, ws)
    assert c.by_op["aten::mm"].flops == 2 * 64 * 64 * 64 * 3 * 4
    want = _ref_count(ref, (64, 64), (3, 64, 64)).flops
    assert abs(c.program().flops - want) / want < TOTAL_TOL


HLO_TYPES = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
             torch.float16: "f16", torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
             torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


@pytest.mark.parametrize("dtype", list(HLO_TYPES), ids=lambda t: str(t).replace("torch.", ""))
def test_byte_helper_matches_the_references(dtype):
    for shape in [(256, 4096), (3, 5, 7), (), (1,)]:
        text = f"{HLO_TYPES[dtype]}[{','.join(map(str, shape))}]{{1,0}}"
        assert hlo_stats._shape_elems_bytes(shape, dtype) == ref_shape_elems_bytes(text)
        t = torch.empty(shape, dtype=dtype)
        assert t.numel() * t.element_size() == ref_shape_elems_bytes(text)[1]


# -- collectives ------------------------------------------------------------------------

_REF_COLL = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.roofline.hlo_stats import analyze
mesh = jax.make_mesh((4,), ("d",))
perm = [(i, (i + 1) % 4) for i in range(4)]
progs = {
    "psum": (lambda x: jax.lax.psum(x, "d"), P()),
    "all_gather": (lambda x: jax.lax.all_gather(x, "d", axis=0, tiled=True), P()),
    "ppermute": (lambda x: jax.lax.ppermute(x, "d", perm), P("d")),
}
out = {}
for name, (body, out_spec) in progs.items():
    f = jax.shard_map(body, mesh=mesh, in_specs=P("d"), out_specs=out_spec, check_vma=False)
    comp = jax.jit(f).lower(jax.ShapeDtypeStruct((64, 32), jnp.float32)).compile()
    out[name] = analyze(comp.as_text()).coll
print("COLL", json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_collectives():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF_COLL], capture_output=True, text=True,
                         env=env, timeout=300)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("COLL ")]
    assert line, res.stdout + res.stderr
    return json.loads(line[0][5:])


_PORT_BODIES = {
    "psum": (lambda x: _collectives.psum(x, "t"), P(None, None)),
    "all_gather": (lambda x: _collectives.all_gather(x, "t", axis=0, tiled=True), P(None, None)),
    "ppermute": (lambda x: _collectives.ppermute(x, "t", [(i, (i + 1) % 4) for i in range(4)]),
                 P("t", None)),
}


@pytest.mark.parametrize("kind", list(_PORT_BODIES))
def test_collectives_count_the_references_bytes_by_kind(ref_collectives, kind):
    body, out_spec = _PORT_BODIES[kind]
    mesh = Mesh((4,), ("t",), device="cpu")
    x = torch.randn(64, 32)
    try:
        with hlo_stats.counting() as c:
            spmd(body, mesh, (P("t", None),), out_spec)(x)
    finally:
        mesh.close()
    assert c.ranks == [0, 1, 2, 3]
    for r in c.ranks:
        assert c.cost(r).coll == ref_collectives[kind]      # exact, every rank
    assert c.cost().coll_bytes == 0                          # the controller moves nothing
    # the communicator's copies are the link's work, not ops of the program
    assert set(c.by_op) == {f"COLL:{hlo_stats.SEAM_KINDS[kind]}"}


def test_counted_psum_bytes_are_the_references_not_the_copies():
    """The thread communicator copies g - 1 shards into each rank for a
    psum (``_collectives.stats``); the counter counts the output once."""
    mesh = Mesh((4,), ("t",), device="cpu")
    _collectives.reset_stats()
    try:
        with hlo_stats.counting() as c:
            spmd(_PORT_BODIES["psum"][0], mesh, (P("t", None),), P(None, None))(
                torch.randn(64, 32))
    finally:
        mesh.close()
    shard = 16 * 32 * 4
    assert c.cost(0).coll["all-reduce"] == shard
    assert _collectives.stats["psum"]["bytes"] == 4 * 3 * shard


# -- K1 and K2 as one op each ---------------------------------------------------------------

FLASH_CASES = {"causal": (2, 96, 96, 4, 4, 16, True, 0),
               "window": (1, 130, 130, 2, 2, 32, True, 40),
               "gqa": (2, 80, 80, 8, 2, 16, True, 0),
               "gqa-window-ragged": (1, 70, 100, 4, 2, 16, True, 24),
               "non-causal": (2, 64, 48, 4, 1, 16, False, 0)}


def _brute_pairs(sq, skv, causal, window):
    rows, cols = np.arange(sq)[:, None], np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    return int(mask.sum())


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_k2_fake_output_and_flops_match_the_plain_version_and_the_pair_count(case):
    b, sq, skv, hq, hkv, d, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    with torch.no_grad():
        plain = mha(q, k, v, causal=causal, window=window)
        with FakeTensorMode() as mode, hlo_stats.counting() as c:
            fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
            fake = mha(fq, fk, fv, causal=causal, window=window)
    assert fake.shape == plain.shape and fake.dtype == plain.dtype
    pairs = _brute_pairs(sq, skv, causal, window)
    assert hlo_stats.attention_pairs(sq, skv, causal, window) == pairs
    assert c.by_op[hlo_stats.K2_OP].flops == 4 * d * b * hq * pairs
    assert c.by_op[hlo_stats.K2_OP].bytes == 2 * b * d * (sq * hq + skv * hkv) * 4
    assert list(c.by_op) == [hlo_stats.K2_OP]      # one op: nothing inside it is counted
    # the plain version the op runs on the CPU is the reference's attention
    heads = lambda x: x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])  # noqa: E731
    want = attention_ref(heads(q), heads(k), heads(v), causal=causal, window=window)
    assert torch.allclose(plain.transpose(1, 2).reshape(-1, sq, d), want, atol=1e-6)


def test_reference_prices_a_pallas_custom_call_at_zero_flops_and_the_port_does_not():
    """The reference's analyzer prices an HLO custom-call (a Pallas kernel)
    at its operand and output bytes and zero FLOPs; the port counts K1 as
    2 m n k (``ROADMAP.md`` queue 3)."""
    hlo = """
HloModule m
ENTRY %main (a: bf16[256,512], b: bf16[512,128]) -> bf16[256,128] {
  %a = bf16[256,512]{1,0} parameter(0)
  %b = bf16[512,128]{1,0} parameter(1)
  ROOT %c = bf16[256,128]{1,0} custom-call(%a, %b), custom_call_target="tpu_custom_call"
}
"""
    ref = ref_analyze(hlo)
    assert ref.flops == 0 and ref.bytes == (256 * 512 + 512 * 128 + 256 * 128) * 2
    a, b = torch.zeros(256, 512, dtype=torch.bfloat16), torch.zeros(512, 128, dtype=torch.bfloat16)
    with hlo_stats.counting() as c:
        matmul(a, b)
    assert c.program().flops == 2 * 256 * 128 * 512 and c.program().bytes == ref.bytes


# -- real and fake runs, and the threads a program runs on ------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b", "xlstm-350m", "deepseek-moe-16b"])
def test_a_fake_run_counts_what_the_real_run_counts(arch):
    cfg = get_smoke_config(arch)

    def step(model, params, device):
        cache = model.init_cache(2, 16, device)
        tokens = torch.ones((2, 1), dtype=torch.int64, device=device)
        with torch.no_grad():
            decode_step(model, params, cache, tokens, 3)

    from repro_torch.models.registry import build_model

    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with hlo_stats.counting() as real:
        step(model, params, torch.device("cpu"))
    with FakeTensorMode():
        _, fparams = abstract_params(cfg, "cpu")
        with hlo_stats.counting() as fake:
            step(model, fparams, torch.device("cpu"))
    assert real.costs == fake.costs and real.by_op == fake.by_op
    assert real.calls[hlo_stats.K1_OP] > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-20b"])    # tied, untied head
def test_the_unembed_counts_as_one_k1_op_with_no_cast_of_the_head(arch):
    """A bf16 decode step has no ``aten::mm`` and no copy of the head (its
    (vp, d) or (d, vp) shape, in any type); the unembedding alone is one
    K1 op of 2 rows d vp FLOPs and nothing that casts or copies."""
    from repro_torch.layers.embed import unembed
    from repro_torch.models.registry import build_model

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    head = params["embed"].get("lm_head", params["embed"]["embedding"])
    vp, d = max(head.shape), min(head.shape)
    with hlo_stats.counting() as step, torch.no_grad():
        cache = model.init_cache(2, 16, "cpu")
        decode_step(model, params, cache, torch.ones((2, 1), dtype=torch.int64), 3)
    copies = [key for key in step.shapes
              if key.split(" ")[0] in ("aten::_to_copy", "aten::clone", "aten::copy_")]
    assert "aten::mm" not in step.calls and step.calls[hlo_stats.K1_OP] > 0
    assert not any(key.endswith((f"[{vp}, {d}]", f"[{d}, {vp}]")) for key in copies), copies
    with hlo_stats.counting() as one, torch.no_grad():
        unembed(params["embed"], torch.ones((2, 3, d), dtype=torch.bfloat16), cfg.vocab_size)
    assert one.calls[hlo_stats.K1_OP] == 1
    assert one.by_op[hlo_stats.K1_OP].flops == 2 * 6 * d * vp
    assert not any(k.startswith(("aten::_to_copy", "aten::clone", "aten::mm"))
                   for k in one.calls), one.calls


def test_the_counter_follows_a_backward_run_on_another_thread():
    """On the card autograd runs the backward on a device thread of its
    own, which takes the dispatch-mode state (and nothing else) from the
    caller; on the CPU the backward runs on the caller's thread.  So the
    backward here runs in a fresh thread given only the caller's mode
    stack: the planned backward's rank programs, found through that stack,
    count as on the caller's thread."""
    mesh = Mesh((2, 2), ("x", "y"), device="cpu")
    a = torch.randn(48, 32, requires_grad=True)
    b = torch.randn(32, 40, requires_grad=True)

    def run(fresh_thread: bool):
        with hlo_stats.counting() as c:
            out = symmetric_matmul(a, b, mesh=mesh, strategy="cannon", out_dtype=torch.float32)
            loss = out.square().sum()
            if not fresh_thread:
                torch.autograd.grad(loss, (a, b))
                return c
            modes = list(_get_current_dispatch_mode_stack())
            errors = []

            def backward():
                try:
                    for m in modes:
                        _push_mode(m)
                    torch.autograd.grad(loss, (a, b))
                except BaseException as e:  # noqa: BLE001 -- re-raised below
                    errors.append(e)
                finally:
                    for _ in modes:
                        _pop_mode()

            t = threading.Thread(target=backward)
            t.start()
            t.join()
            if errors:
                raise errors[0]
        return c

    try:
        here, there = run(False), run(True)
    finally:
        mesh.close()
    assert here.costs == there.costs and here.by_op == there.by_op
    # forward, dA and dB: three planned products, each 4 rank programs of K1 calls
    assert here.calls[hlo_stats.K1_OP] == 3 * 4 * 2
    assert here.cost().flops > 0 and all(here.cost(r) == here.cost(0) for r in here.ranks)


# -- Roofline ----------------------------------------------------------------------------

ROOF_CASES = [dict(flops=1e15, hbm_bytes=1e12, coll_bytes=1e10, coll_by_kind={},
                   model_flops=2.56e17, chips=256),
              dict(flops=3e12, hbm_bytes=5e12, coll_bytes=0.0,
                   coll_by_kind={"all-gather": 0}, model_flops=None, chips=1),
              dict(flops=1e9, hbm_bytes=1e6, coll_bytes=4e11,
                   coll_by_kind={"collective-permute": 4e11}, model_flops=1e9, chips=4)]


@pytest.mark.parametrize("case", range(len(ROOF_CASES)))
def test_roofline_at_the_references_constants_equals_the_references(case):
    kw = ROOF_CASES[case]
    ref = ref_analysis.Roofline(**kw)
    port = analysis.Roofline(**kw, peak_flops=ref_cost.PEAK_FLOPS_BF16, hbm_bw=ref_cost.HBM_BW,
                             link_bw=ref_cost.ICI_BW)
    assert port.summary() == ref.summary()


def test_roofline_prices_at_the_cards_rates_by_default():
    r = analysis.Roofline(**ROOF_CASES[0])
    assert r.compute_s == 1e15 / 989e12 and r.memory_s == 1e12 / 3.35e12
    assert r.collective_s == 1e10 / 450e9
    assert analysis.PEAK_FLOPS[torch.bfloat16] == 989e12 and analysis.HBM_BW == 3.35e12
    cost = hlo_stats.Cost(2e12, 1e9)
    cost.coll["all-reduce"] = 5.0
    r = analysis.from_cost(cost, chips=2, model_flops=4e12)
    assert (r.flops, r.hbm_bytes, r.coll_bytes) == (2e12, 1e9, 5.0)
    assert r.coll_by_kind == {"all-gather": 0, "all-reduce": 5, "reduce-scatter": 0,
                              "all-to-all": 0, "collective-permute": 0}
    assert r.dominant == "compute" and r.useful_flops_fraction == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_references(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    for tokens in (1, 128, 256 * 4096):
        assert analysis.train_model_flops(cfg.active_param_count(), tokens) == \
            ref_analysis.train_model_flops(ref_cfg.active_param_count(), tokens)
        assert analysis.infer_model_flops(cfg.active_param_count(), tokens) == \
            ref_analysis.infer_model_flops(ref_cfg.active_param_count(), tokens)


def test_analyze_and_analyze_by_shape_read_one_run():
    x, w = torch.randn(64, 32), torch.randn(32, 48)

    def program(x, w):
        return torch.tanh(x @ w).sum()

    cost = hlo_stats.analyze(program, x, w)
    with hlo_stats.counting() as c:
        program(x, w)
    # the reduction counts one flop per output element, as the reference does
    assert cost == c.program() and cost.flops == 2 * 64 * 48 * 32 + 64 * 48 + 1
    rows = hlo_stats.analyze_by_shape(program, x, w, top=2)
    assert rows == [("aten::mm float32[64, 48]", (64 * 32 + 32 * 48 + 64 * 48) * 4.0),
                    ("aten::tanh float32[64, 48]", 2 * 64 * 48 * 4.0)]
