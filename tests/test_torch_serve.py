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
from repro_torch.models.config import port_only_defaults
from repro_torch.models.registry import build_model
from repro_torch.dist import Mesh
from repro_torch.plan import planned_matmuls
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
        # a mesh is a repro_torch Mesh or its sizes; a strategy needs a mesh
        with pytest.raises(ValueError, match="mesh"):
            Server(tmodel, tparams, ServeConfig(), mesh=object())
        with pytest.raises(ValueError, match="needs a mesh"):
            Server(tmodel, tparams, ServeConfig(), strategy="cannon")
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
    # every architecture of the reference is ported; an unknown one raises
    with pytest.raises(ValueError, match="not ported"):
        get_config("mamba3-8b")


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_configs_hold_the_reference_danube(which):
    """The port's h2o-danube-3-4b is the reference's, field by field."""
    get = {"CONFIG": (get_config, jax_get_config),
           "SMOKE": (get_smoke_config, jax_smoke_config)}[which]
    port, ref = (g("h2o-danube-3-4b") for g in get)
    # the reference's fields, and the port's own at the defaults that keep them
    assert dataclasses.asdict(port) == {**dataclasses.asdict(ref), **port_only_defaults()}
    if which == "CONFIG":
        assert (port.num_layers, port.d_model, port.num_heads, port.num_kv_heads,
                port.d_ff, port.vocab_size, port.head_dim, port.window) == (
                    24, 3840, 32, 8, 10240, 32000, 120, 4096)


@pytest.mark.parametrize("strategy", [None, "cannon", "summa"])
def test_plan_routed_server_matches_local(pair, strategy):
    """``Server(mesh=(2, 2))`` on the CPU, the cost model ranking (None) or
    one strategy pinned: every projection runs as per-rank programs on a
    2x2 single-controller mesh, and the served tokens equal ``mesh=None``'s
    with the prefill logits within 1e-5.  ``mesh=None`` is the oracle: the
    reference's plan-routed serving does not run on this JAX."""
    _, _, tmodel, tparams = pair
    scfg = ServeConfig(max_new_tokens=6, max_seq=32)
    local = Server(tmodel, tparams, scfg, buckets=[(4, 8)])
    planned = Server(tmodel, tparams, scfg, mesh=(2, 2), strategy=strategy, buckets=[(4, 8)])
    assert isinstance(planned.mesh, Mesh) and planned.mesh.device == torch.device("cpu")
    local.warmup()
    planned.warmup()
    for prompts in (PROMPTS, [[3] * 12, [4, 5]]):         # bucketed, then cold
        lr, pr = local.generate(prompts), planned.generate(prompts)
        assert pr.bucket == lr.bucket and pr.new_tokens == lr.new_tokens
    report = planned.plan_report()
    assert report["mesh"] == {"x": 2, "y": 2} and report["strategy"] == strategy
    taken = {k.split("+")[0] for k in report["strategies"]}
    per_forward = 7 * tmodel.cfg.num_layers
    assert sum(report["strategies"].values()) == 2 * 6 * per_forward
    assert taken == ({strategy} if strategy else taken) and taken
    assert sum(report["warmup_strategies"].values()) == 3 * per_forward
    assert local.plan_report()["strategies"] == {}
    batch, lens = batch_requests(PROMPTS)
    offsets = torch.from_numpy((batch.shape[1] - lens).astype(np.int64))
    tokens = torch.from_numpy(batch).long()
    with torch.no_grad():
        ref, _ = tmodel.prefill(tparams, tmodel.init_cache(4, 16, torch.device("cpu")),
                                tokens, offsets)
        with planned_matmuls(planned.mesh, strategy):
            out, _ = tmodel.prefill(tparams, tmodel.init_cache(4, 16, torch.device("cpu")),
                                    tokens, offsets)
    assert _rel_err(out, ref.numpy()) < 1e-5
    # the runtime's generate takes the same mesh
    np.testing.assert_array_equal(
        generate(tmodel, tparams, batch, scfg, lens=lens, mesh=planned.mesh, strategy=strategy),
        generate(tmodel, tparams, batch, scfg, lens=lens))


# -- measurement loop: tuning, obs, captured buckets (eager on the CPU) -----------------


def _timer(m, n, k, dtype, cand):
    bm, bn, bk, order = cand
    return 1e-9 * m * n * k * (1 + (order == "rowmajor") + (bm == 16))


def test_tuned_plan_routed_server_matches_local(pair):
    """``Server(mesh=(2, 2), tuning=tuner)``: warmup tunes every bucket's
    per-rank kernel shapes (an injected timer: there is no kernel to time
    on the CPU), serving searches nothing more, and the tokens equal
    ``mesh=None``'s."""
    from repro_torch.tune import Tuner

    _, _, tmodel, tparams = pair
    scfg = ServeConfig(max_new_tokens=6, max_seq=32)
    tuner = Tuner(device="cpu", timer=_timer)
    local = Server(tmodel, tparams, scfg, buckets=[(4, 8)])
    tuned = Server(tmodel, tparams, scfg, mesh=(2, 2), tuning=tuner, buckets=[(4, 8)])
    local.warmup()
    report = tuned.warmup()
    assert report["4x8"]["plans"] > 0 and "graphs" not in report["4x8"]
    searches = tuner.stats["searches"]
    assert searches > 0
    lr, tr = local.generate(PROMPTS), tuned.generate(PROMPTS)
    assert tr.new_tokens == lr.new_tokens and not tr.graphs
    assert tr.plan_probe["missing"] == 0 and tr.plan_probe["tune_missing"] == 0
    assert tr.plan_probe["tune_probed"] == searches
    rep = tuned.cache_report()["tuning"]
    assert rep["entries"] == searches and tuner.stats["searches"] == searches
    assert rep["serve_window"]["misses"] == 0 and rep["serve_window"]["hit_rate"] in (1.0, None)
    assert tuned.plan_report()["serve_window"]["misses"] == 0


def test_server_counts_and_times_requests_under_obs(pair):
    from repro_torch import obs

    _, _, tmodel, tparams = pair
    obs.reset_metrics()
    srv = Server(tmodel, tparams, ServeConfig(max_new_tokens=4, max_seq=32), buckets=[(4, 8)])
    try:
        with obs.observe() as rec:
            srv.warmup()
            srv.generate(PROMPTS)
            srv.generate([[3] * 12])            # longer than any bucket: cold
        snap = obs.snapshot()
        spans = rec.span_counts()
    finally:
        obs.reset()
        obs.reset_metrics()
    assert snap["serve.warmup.buckets"] == 1 and snap["serve.cold_bucket"] == 1
    assert snap["serve.requests{bucket=4x8}"] == 4 and snap["serve.requests{bucket=cold}"] == 1
    assert snap["serve.tokens"] == 5 * 4
    assert snap["serve.ttft_us"]["count"] == 2 and snap["serve.decode_token_us"]["count"] == 6
    assert spans["serve.warmup"] == 1 and spans["serve.prefill"] == 3
    assert spans["serve.decode_step"] == 2 + 3 + 3 and spans["kernel.matmul"] > 0
    assert not obs.enabled()


def test_a_cpu_server_serves_eagerly_and_reports_no_graphs(pair):
    _, _, tmodel, tparams = pair
    srv = Server(tmodel, tparams, ServeConfig(max_new_tokens=3, max_seq=32), buckets=[(4, 8)])
    assert not srv.graphs
    srv.warmup()
    res = srv.generate(PROMPTS)
    assert not res.graphs and res.bucket == "4x8"
    rep = srv.cache_report()
    assert rep["graphs"] == {} and rep["kernels"]["zorder_matmul"]["replayed"] == 0


@pytest.mark.parametrize("prompts", [PROMPTS, PROMPTS[:2], [[3] * 7]])
def test_server_tokens_are_generate_on_the_bucket_padded_batch(pair, prompts):
    """The eager baseline the captured buckets are held to on the card:
    ``generate`` on ``batch_requests(prompts + dummies, pad_to=bucket.seq)``
    gives the server's tokens, dummy rows and padding stripped."""
    from repro_torch.serve.server import DUMMY_TOKEN, PAD_ID

    _, _, tmodel, tparams = pair
    scfg = ServeConfig(max_new_tokens=5, max_seq=32)
    srv = Server(tmodel, tparams, scfg, buckets=[(2, 8), (4, 8)])
    srv.warmup()
    res = srv.generate(prompts)
    bucket = route(len(prompts), max(len(p) for p in prompts), srv.buckets)
    assert res.bucket == bucket.label
    batch, lens = batch_requests(list(prompts) + [[DUMMY_TOKEN]] * (bucket.batch - len(prompts)),
                                 PAD_ID, pad_to=bucket.seq)
    full = generate(tmodel, tparams, batch, scfg, lens=lens)
    sp = batch.shape[1]
    assert res.sequences == [full[i, sp - int(lens[i]):].tolist() for i in range(len(prompts))]


def test_server_pad_and_dummy_tokens_and_warmed_buckets_match_the_reference(monkeypatch):
    """``Server(pad_id=, dummy_token=)`` with only one of two buckets warmed
    (``warmup(buckets=)``) on the fp32 smoke qwen3-moe, whose routing groups
    hold a row's padding beside its prompt (so the pad token moves the
    tokens): requests routed to the warmed bucket and to the one not warmed
    (served eagerly on the CPU, compiled on first use by the reference) give
    the reference ``Server``'s tokens with the same arguments, and the
    batch the port decodes is padded with ``pad_id`` and ``dummy_token``."""
    from repro_torch.serve import server as server_mod

    arch, kw = "qwen3-moe-30b-a3b", dict(buckets=[(2, 8), (4, 16)], pad_id=7, dummy_token=11)
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    scfg = dict(max_new_tokens=5, max_seq=32)
    jsrv = JaxServer(jmodel, jparams, JaxServeConfig(**scfg), **kw)
    tsrv = Server(build_model(tcfg), tparams, ServeConfig(**scfg), **kw)
    assert set(jsrv.warmup(buckets=[(2, 8)])) == set(tsrv.warmup(buckets=[(2, 8)])) == {"2x8"}
    decoded = []
    real_loop = server_mod.decode_loop

    def spy(model, params, cache, tokens, *args, **kwargs):
        decoded.append(tokens.clone())
        return real_loop(model, params, cache, tokens, *args, **kwargs)

    monkeypatch.setattr(server_mod, "decode_loop", spy)
    for prompts, bucket in ((PROMPTS[:2], "2x8"), (PROMPTS[:3], "4x16"),
                            ([[3] * 12, [4, 5]], "4x16")):
        jr, tr = jsrv.generate(prompts), tsrv.generate(prompts)
        assert tr.bucket == jr.bucket == bucket
        assert tr.sequences == jr.sequences
        b, s = (int(x) for x in bucket.split("x"))
        want, _ = batch_requests(list(prompts) + [[11]] * (b - len(prompts)), 7, pad_to=s)
        assert decoded[-1].tolist() == want.tolist()
    default = Server(build_model(tcfg), tparams, ServeConfig(**scfg), buckets=[(4, 16)])
    assert default.generate(PROMPTS[:3]).sequences != tr.sequences or \
        default.generate([[3] * 12, [4, 5]]).sequences != tsrv.generate([[3] * 12, [4, 5]]).sequences


def test_generate_checks_each_slot_on_the_host(pair, monkeypatch):
    """The decode loop checks every slot on the host before the step that
    takes it as a device tensor."""
    _, _, tmodel, tparams = pair
    seen = []
    real = tmodel.check_decode_pos

    def spy(cache, pos):
        seen.append(pos)
        return real(cache, pos)

    monkeypatch.setattr(tmodel, "check_decode_pos", spy)
    generate(tmodel, tparams, np.array([[5, 6, 7]], np.int32),
             ServeConfig(max_new_tokens=4, max_seq=16))
    assert seen == [3, 4, 5]


# -- the MoE and MLA decoders, and the dense configs that lacked only their file --------

ZOO = ["deepseek-moe-16b", "qwen3-moe-30b-a3b", "minicpm3-4b", "granite-20b", "chameleon-34b"]


def _row_rel(port, ref) -> float:
    """Worst row's relative L2 error (rows along the last dim)."""
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    p, r = port.reshape(-1, ref.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float(np.max(np.linalg.norm(p - r, axis=1)
                        / np.maximum(np.linalg.norm(r, axis=1), 1e-30)))


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ZOO)
def test_configs_hold_the_reference_zoo(arch, which):
    """Each new config is the reference's, field by field."""
    get = {"CONFIG": (get_config, jax_get_config),
           "SMOKE": (get_smoke_config, jax_smoke_config)}[which]
    port, ref = (g(arch) for g in get)
    # the reference's fields, and the port's own at the defaults that keep them
    assert dataclasses.asdict(port) == {**dataclasses.asdict(ref), **port_only_defaults()}


def test_full_width_zoo_shapes():
    """The two models served on the card: deepseek-moe-16b (a dense first
    layer, 27 MoE layers of 64 routed experts top-6 and 2 shared) and
    minicpm3-4b (62 MLA layers)."""
    ds, mc = get_config("deepseek-moe-16b"), get_config("minicpm3-4b")
    assert (ds.num_layers, ds.first_dense_layers, ds.num_experts, ds.top_k,
            ds.num_shared_experts, ds.moe_d_ff, ds.d_ff) == (28, 1, 64, 6, 2, 1408, 10944)
    assert (mc.num_layers, mc.attn_type, mc.q_lora_rank, mc.kv_lora_rank) == (62, "mla", 768,
                                                                               256)
    assert all(get_config(a).remat == "dots" for a in ZOO)
    for arch, family in zip(ZOO, ("moe", "moe", "dense", "dense", "vlm")):
        assert type(build_model(get_config(arch))).__name__ == "DecoderLM"
        assert get_config(arch).family == family


@pytest.fixture(scope="module", params=ZOO)
def zoo(request):
    """(jax model, jax params, port model, port params) of one fp32 smoke
    model of the zoo."""
    arch = request.param
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def test_zoo_forward_loss_and_aux_match_jax(zoo):
    """Logits per row within 1e-5 over the real vocabulary, the loss within
    1e-5 and the MoE aux loss within 1e-6 (0 for the dense models)."""
    jmodel, jparams, tmodel, tparams = zoo
    v = tmodel.cfg.vocab_size
    rng = np.random.default_rng(20)
    tokens = rng.integers(0, v, size=(2, 64))
    labels = rng.integers(0, v, size=(2, 64))
    labels[0, :5] = -100
    ref, ref_aux = jmodel.forward(jparams, jnp.asarray(tokens))
    ref_loss, ref_parts = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens),
                                                "labels": jnp.asarray(labels)})
    with torch.no_grad():
        out, aux = tmodel.forward(tparams, torch.from_numpy(tokens))
        loss, parts = tmodel.loss(tparams, {"tokens": torch.from_numpy(tokens),
                                            "labels": torch.from_numpy(labels)})
    assert _row_rel(out[..., :v], np.asarray(ref)[..., :v]) < 1e-5
    assert abs(float(aux) - float(ref_aux)) < 1e-6
    assert abs(float(parts["aux"]) - float(ref_parts["aux"])) < 1e-6
    assert abs(float(loss) - float(ref_loss)) < 1e-5 * abs(float(ref_loss))
    assert (float(aux) > 0) == bool(tmodel.cfg.num_experts)


@pytest.mark.parametrize("with_offsets", [False, True])
def test_zoo_prefill_and_tensor_slot_decode_match_jax(zoo, with_offsets):
    """``prefill(offsets=)`` over a left-padded batch, then 4 decode steps
    with the slot a 0-d tensor: last-token logits per row within 1e-5."""
    jmodel, jparams, tmodel, tparams = zoo
    v = tmodel.cfg.vocab_size
    prompts = [[5, 6, 7], [9, 2, 3, 4, 1], [17, 3], [8, 8, 8, 8, 8, 8, 1, 2]]
    batch, lens = batch_requests(prompts)
    b, sp = batch.shape
    off = (sp - lens).astype(np.int64) if with_offsets else None
    jo = jnp.asarray(off, jnp.int32) if with_offsets else None
    to = torch.from_numpy(off) if with_offsets else None
    jcache = jmodel.init_cache(b, 16)
    tcache = tmodel.init_cache(b, 16, torch.device("cpu"))
    ref, jcache = jmodel.prefill(jparams, jcache, jnp.asarray(batch), jo)
    with torch.no_grad():
        out, tcache = tmodel.prefill(tparams, tcache, torch.from_numpy(batch).long(), to)
    assert _row_rel(out[:, :v], np.asarray(ref)[:, :v]) < 1e-5
    cur = np.argmax(np.asarray(ref)[:, :v], axis=-1)
    for t in range(sp, sp + 4):
        ref, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(cur[:, None]),
                                         jnp.int32(t), jo)
        with torch.no_grad():
            out, tcache = tmodel.decode_step(tparams, tcache,
                                             torch.from_numpy(cur[:, None]).long(),
                                             torch.tensor(t), to)
        assert _row_rel(out[:, :v], np.asarray(ref)[:, :v]) < 1e-5
        cur = np.argmax(np.asarray(ref)[:, :v], axis=-1)


def test_zoo_server_tokens_match_reference_generate(zoo):
    """``Server`` (bucket 4x16) against the reference's ``generate`` on the
    same bucket-padded batch (``batch_requests(prompts + dummies,
    pad_to=16)``): greedy tokens equal.  The MoE routes the padded batch,
    pad tokens included, so the reference is run on that batch, not on each
    prompt alone."""
    from repro_torch.serve.server import DUMMY_TOKEN, PAD_ID

    jmodel, jparams, tmodel, tparams = zoo
    scfg = dict(max_new_tokens=6, max_seq=32)
    srv = Server(tmodel, tparams, ServeConfig(**scfg), buckets=[(4, 16)])
    srv.warmup()
    for prompts in (PROMPTS, PROMPTS[:3]):
        res = srv.generate(prompts)
        assert res.bucket == "4x16"
        batch, lens = batch_requests(list(prompts) + [[DUMMY_TOKEN]] * (4 - len(prompts)),
                                     PAD_ID, pad_to=16)
        full = jax_generate(jmodel, jparams, batch, JaxServeConfig(**scfg), lens=lens)
        assert res.sequences == [full[i, 16 - int(lens[i]):].tolist()
                                 for i in range(len(prompts))]


def test_zoo_params_and_optimizer_state_cross_both_ways_bitwise(zoo):
    """The reference's tree (``dense_layers``, the stacked (L, E, d, ff)
    expert weights, the fp32 router, the shared experts, the MLA leaves) into
    the port and back, leaf for leaf; AdamW state too."""
    from repro.optim import adamw as jax_adamw
    from repro_torch.checkpoint import params_to_jax, state_from_jax, state_to_jax

    jmodel, jparams, tmodel, _ = zoo
    cfg = tmodel.cfg
    for tree, there, back in (
            (jparams, lambda t: params_from_jax(t, cfg, device="cpu"), params_to_jax),
            (jax_adamw.init(jparams), lambda t: state_from_jax(t, cfg, device="cpu"),
             state_to_jax)):
        np_tree = jax.tree.map(np.asarray, tree)
        round_trip = back(there(np_tree))
        want = jax.tree_util.tree_flatten_with_path(np_tree)[0]
        got = dict(jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t.float().numpy(), round_trip))[0])
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], np.asarray(leaf, np.float32),
                                          err_msg=jax.tree_util.keystr(path))
    stacks = {k: len(v) for k, v in params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu").items() if k.endswith("layers")}
    nd = cfg.first_dense_layers
    assert stacks == ({"dense_layers": nd} if nd else {}) | {"layers": cfg.num_layers - nd}


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b"])
def test_moe_padding_routes_pad_tokens_as_the_reference_does(arch):
    """Reference behaviour, copied on purpose: the MoE routes pad tokens and
    sizes its groups by the padded length, so a 12-token prompt left-padded
    by 4 into a 16-token batch gives last-token logits far (> 1e-2) from
    the same prompt prefilled alone, on both packages alike, while each
    agrees with the other within 1e-5.  Without MoE (minicpm3) padding
    changes nothing past fp32 rounding."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    v = tcfg.vocab_size
    prompt = np.random.default_rng(21).integers(1, v, size=(1, 12))
    padded = np.concatenate([np.zeros((1, 4), prompt.dtype), prompt], axis=1)
    logits = {}
    for name, toks, off in (("alone", prompt, None), ("padded", padded, np.array([4]))):
        ref, _ = jmodel.prefill(jparams, jmodel.init_cache(1, 16), jnp.asarray(toks),
                                None if off is None else jnp.asarray(off, jnp.int32))
        with torch.no_grad():
            out, _ = tmodel.prefill(tparams, tmodel.init_cache(1, 16, torch.device("cpu")),
                                    torch.from_numpy(toks),
                                    None if off is None else torch.from_numpy(off))
        assert _row_rel(out[:, :v], np.asarray(ref)[:, :v]) < 1e-5
        logits[name] = (out[:, :v], np.asarray(ref)[:, :v])
    port_gap = _row_rel(logits["padded"][0], logits["alone"][0].numpy())
    ref_gap = _row_rel(logits["padded"][1], logits["alone"][1])
    if tcfg.num_experts:
        assert port_gap > 1e-2 and ref_gap > 1e-2
    else:
        assert port_gap < 1e-5 and ref_gap < 1e-5


@pytest.mark.parametrize("arch", ZOO)
def test_launcher_serves_the_zoo_smoke_on_cpu(arch, capsys):
    from repro_torch.launch import serve as launch_serve

    assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--max-new", "3",
                              "--buckets", "4x16"]) == 0
    out = capsys.readouterr().out
    assert f"arch={get_smoke_config(arch).name}" in out and "bucket=4x16" in out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b"])
def test_plan_routed_zoo_server_matches_local(arch):
    """``Server(mesh=(2, 2))`` on the CPU thread mesh: every ``linear``
    (attention, the dense layer, the shared experts, MLA's projections) runs
    through the plan engine, the MoE and MLA einsums stay local, and the
    tokens equal ``mesh=None``'s; 7 planned products a layer a forward."""
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tmodel = build_model(tcfg)
    tparams = tmodel.init(torch.Generator().manual_seed(3), "cpu")
    scfg = ServeConfig(max_new_tokens=4, max_seq=32)
    local = Server(tmodel, tparams, scfg, buckets=[(4, 8)])
    planned = Server(tmodel, tparams, scfg, mesh=(2, 2), buckets=[(4, 8)])
    local.warmup()
    planned.warmup()
    assert planned.generate(PROMPTS).new_tokens == local.generate(PROMPTS).new_tokens
    assert sum(planned.plan_report()["strategies"].values()) == 4 * 7 * tcfg.num_layers


def test_server_zeroes_the_dense_layers_cache_too():
    """A bucket's cache is zeroed for each batch, the leading dense layers'
    included: the same batch served twice gives the same tokens, and
    ``_zero`` clears every leaf of an MoE or MLA model's cache."""
    from repro_torch.serve.server import _zero

    for arch in ("deepseek-moe-16b", "minicpm3-4b"):
        tmodel = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32"))
        cache = tmodel.init_cache(2, 8, torch.device("cpu"))
        for stack in cache.values():
            for layer in stack:
                for t in layer.values():
                    t.fill_(1.0)
        _zero(cache)
        assert all(not t.any() for stack in cache.values() for layer in stack
                   for t in layer.values())
        assert ("dense_layers" in cache) == (arch == "deepseek-moe-16b")
        tparams = tmodel.init(torch.Generator().manual_seed(4), "cpu")
        srv = Server(tmodel, tparams, ServeConfig(max_new_tokens=4, max_seq=32),
                     buckets=[(4, 8)])
        srv.warmup()
        assert srv.generate(PROMPTS).new_tokens == srv.generate(PROMPTS).new_tokens
