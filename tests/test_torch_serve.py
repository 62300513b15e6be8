"""The port's serving slice against the JAX package's, on the CPU.

The JAX smoke Llama in fp32 (``dataclasses.replace(..., dtype="float32")``,
so greedy argmax margins sit far above summation-order noise) is converted
with ``params_from_jax``.  Logits agree to 1e-4 of their largest magnitude;
greedy tokens agree exactly.  Routing and config validation behave as in
``tests/test_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.serve import Server as JaxServer
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import generate as jax_generate
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve import ServeConfig, batch_requests, generate
from repro_torch.serve import Bucket, Server, bucket_grid, route, warmup

TOL = 1e-4
PROMPTS = [[5, 6, 7], [9, 2, 3, 4, 1], [17, 3], [8, 8, 8, 8, 8, 8, 1]]


def _rel_err(port, ref):
    port, ref = port.detach().float().numpy(), np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.max(np.abs(port - ref)) / (np.max(np.abs(ref)) + 1e-12)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) on the fp32 smoke Llama."""
    jcfg = dataclasses.replace(jax_smoke_config("llama3_2_1b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def test_forward_logits_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 64))
    ref, _ = jmodel.forward(jparams, jnp.asarray(tokens))
    out, aux = tmodel.forward(tparams, torch.from_numpy(tokens))
    assert out.shape == (2, 64, 256) and float(aux) == 0.0
    assert _rel_err(out, ref) < TOL


@pytest.mark.parametrize("with_offsets", [False, True])
def test_prefill_and_decode_logits_match_jax(pair, with_offsets):
    jmodel, jparams, tmodel, tparams = pair
    batch, lens = batch_requests(PROMPTS)
    b, sp = batch.shape
    off = (sp - lens).astype(np.int64) if with_offsets else None
    jcache = jmodel.init_cache(b, 16)
    tcache = tmodel.init_cache(b, 16, torch.device("cpu"))
    jo = jnp.asarray(off, jnp.int32) if with_offsets else None
    to = torch.from_numpy(off) if with_offsets else None
    ref, jcache = jmodel.prefill(jparams, jcache, jnp.asarray(batch), jo)
    out, tcache = tmodel.prefill(tparams, tcache, torch.from_numpy(batch).long(), to)
    assert _rel_err(out, ref) < TOL
    cur = np.argmax(np.asarray(ref), axis=-1)
    for t in range(sp, sp + 4):
        ref, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(cur[:, None]),
                                         jnp.int32(t), jo)
        out, tcache = tmodel.decode_step(tparams, tcache,
                                         torch.from_numpy(cur[:, None]).long(), t, to)
        assert _rel_err(out, ref) < TOL
        cur = np.argmax(np.asarray(ref), axis=-1)


def test_generate_matches_jax_on_left_padded_batch(pair):
    jmodel, jparams, tmodel, tparams = pair
    scfg = dict(max_new_tokens=6, max_seq=32)
    batch, lens = batch_requests(PROMPTS)
    ref = jax_generate(jmodel, jparams, batch, JaxServeConfig(**scfg), lens=lens)
    out = generate(tmodel, tparams, batch, ServeConfig(**scfg), lens=lens)
    np.testing.assert_array_equal(out, ref)


def test_server_greedy_tokens_match_jax_server(pair):
    """Bucketed (4x8), cold (longer than any bucket) and repeated batches:
    the port's ``Server`` returns the JAX ``Server(mesh=None)``'s tokens."""
    jmodel, jparams, tmodel, tparams = pair
    scfg = dict(max_new_tokens=6, max_seq=32)
    jsrv = JaxServer(jmodel, jparams, JaxServeConfig(**scfg), buckets=[(4, 8)])
    tsrv = Server(tmodel, tparams, ServeConfig(**scfg), buckets=[(4, 8)])
    jsrv.warmup()
    report = tsrv.warmup()
    assert set(report) == {"4x8"}
    for prompts in (PROMPTS, PROMPTS[:2], [[3] * 12, [4, 5]]):
        jr, tr = jsrv.generate(prompts), tsrv.generate(prompts)
        assert tr.bucket == jr.bucket
        assert tr.sequences == jr.sequences
        assert tr.new_tokens == jr.new_tokens
        assert all(len(t) == 6 for t in tr.new_tokens)
        assert tr.step_latencies_s.shape == (5,) and tr.ttft_s > 0
    rep = tsrv.cache_report()["kernels"]["zorder_matmul"]
    assert rep["since_warmup"] == 0          # the CPU runs the plain version


def test_server_empty_and_zero_new_tokens(pair):
    _, _, tmodel, tparams = pair
    srv = Server(tmodel, tparams, ServeConfig(max_new_tokens=2, max_seq=64),
                 buckets=[(2, 8)])
    assert srv.generate([]).sequences == []
    zero = Server(tmodel, tparams, ServeConfig(max_new_tokens=0, max_seq=64),
                  buckets=[(2, 8)])
    r0 = zero.generate([[5, 6, 7]])
    assert r0.new_tokens == [[]] and r0.sequences == [[5, 6, 7]]
    assert r0.latency_quantiles_ms() == {"p50_ms": None, "p99_ms": None}


def test_warmup_helper_returns_warm_server(pair):
    _, _, tmodel, tparams = pair
    srv = warmup(tmodel, tparams, ServeConfig(max_new_tokens=2, max_seq=64),
                 buckets=[(2, 8)])
    assert "2x8" in srv.warmup_report
    res = srv.generate([[4, 5]])
    assert res.bucket == "2x8" and len(res.new_tokens[0]) == 2


@pytest.mark.parametrize("case", ["mesh", "bucket_overruns_cache"])
def test_server_rejects(pair, case):
    _, _, tmodel, tparams = pair
    if case == "mesh":
        with pytest.raises(NotImplementedError, match="mesh"):
            Server(tmodel, tparams, ServeConfig(), mesh=object())
    else:
        with pytest.raises(ValueError, match="max_seq"):
            Server(tmodel, tparams, ServeConfig(max_new_tokens=8, max_seq=16),
                   buckets=[(2, 16)])


def test_decode_past_cache_end_raises(pair):
    _, _, tmodel, tparams = pair
    cache = tmodel.init_cache(1, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="overruns"):
        tmodel.decode_step(tparams, cache, torch.ones(1, 1, dtype=torch.long), 4)


@pytest.mark.parametrize("kw, field", [
    (dict(max_new_tokens=-1), "max_new_tokens"),
    (dict(max_seq=0), "max_seq"),
    (dict(temperature=-0.5), "temperature"),
])
def test_serveconfig_rejects_bad_fields(kw, field):
    with pytest.raises(ValueError, match=field):
        ServeConfig(**kw)


def test_generate_cache_overrun_raises(pair):
    _, _, tmodel, tparams = pair
    with pytest.raises(ValueError, match="max_seq"):
        generate(tmodel, tparams, np.array([[1] * 30], np.int32),
                 ServeConfig(max_new_tokens=8, max_seq=32))


def test_temperature_sampling_reproducible_under_fixed_generator(pair):
    _, _, tmodel, tparams = pair
    cfg = ServeConfig(max_new_tokens=6, max_seq=32, temperature=0.8)
    prompts = np.array([[5, 6, 7], [9, 2, 3]], np.int32)
    a = generate(tmodel, tparams, prompts, cfg, torch.Generator().manual_seed(42))
    b = generate(tmodel, tparams, prompts, cfg, torch.Generator().manual_seed(42))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 9)


def test_batch_requests():
    batch, lens = batch_requests([[1, 2, 3], [7]], pad_id=9)
    assert batch.tolist() == [[1, 2, 3], [9, 9, 7]] and lens.tolist() == [3, 1]
    batch, lens = batch_requests([[1, 2]], pad_to=5)
    assert batch.tolist() == [[0, 0, 0, 1, 2]] and lens.tolist() == [2]
    empty, elens = batch_requests([])
    assert empty.shape == (0, 0) and elens.shape == (0,)
    with pytest.raises(ValueError, match="pad_to"):
        batch_requests([[1, 2, 3]], pad_to=2)
    with pytest.raises(ValueError, match="empty"):
        batch_requests([[1, 2], []])


def test_bucket_grid_and_route():
    with pytest.raises(ValueError):
        Bucket(0, 8)
    assert [b.label for b in bucket_grid([4, 2], [32, 16])] == \
        ["2x16", "2x32", "4x16", "4x32"]
    buckets = bucket_grid([2, 4], [16, 32])
    assert route(2, 10, buckets) == Bucket(2, 16)
    assert route(3, 10, buckets) == Bucket(4, 16)
    assert route(2, 20, buckets) == Bucket(2, 32)
    assert route(5, 10, buckets) is None
    assert route(2, 40, buckets) is None


def test_configs_hold_the_published_llama():
    cfg = get_config("llama3.2-1b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.head_dim) == (16, 2048, 32, 8, 8192,
                                                        128256, 64)
    # 7 projections per layer stream 60.8M weights: the decode bound's bytes
    per_layer = cfg._attn_params() + cfg._mlp_params(cfg.d_ff)
    assert per_layer == 60_817_408
    with pytest.raises(ValueError, match="not ported"):
        get_config("granite-20b")


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_hold_the_reference_danube(which):
    """The port's h2o-danube-3-4b is the reference's, field by field."""
    get = {"CONFIG": (get_config, jax_get_config),
           "SMOKE": (get_smoke_config, jax_smoke_config)}[which]
    port, ref = (g("h2o-danube-3-4b") for g in get)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if which == "CONFIG":
        assert (port.num_layers, port.d_model, port.num_heads, port.num_kv_heads,
                port.d_ff, port.vocab_size, port.head_dim, port.window) == (
                    24, 3840, 32, 8, 10240, 32000, 120, 4096)
