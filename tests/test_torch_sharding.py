"""The port's sharding rules, placement, planned backward, int8 compression
and elastic re-meshing against the JAX package's, on the CPU.

* Specs: every config of ``src/repro/configs/``, built abstractly on both
  sides (``jax.eval_shape`` there, ``FakeTensorMode`` here), on six
  meshes: the port's ``param_specs``, ``param_shardings`` (with and
  without ``auto_matmul``), ``zero_shardings`` and ``cache_shardings``
  (``shard_batch`` both ways) equal the reference's leaf for leaf.  The
  reference stacks each per-layer leaf on a leading layer axis and the port
  keeps a list of per-layer leaves, so the rules are compared twice: on
  the reference's own tree (its spec without the layer axis's leading
  entry) and with the reference's functions run on a tree of the port's
  layout (equal as they stand; ``zero_shardings`` only this way, since the
  reference's may pick the layer axis itself).
* Products: dA and dB of ``symmetric_matmul`` for every strategy and
  overlap setting the gloo worlds run, on thread meshes, 2-D, 3-D and
  ragged, against ``jax.grad`` of the reference's ``a @ b`` (fp32, 2e-5 of
  the largest entry).
* Placement: blocks, shared replicas, the placed AdamW step.
* Compression: ``quantize_int8`` / ``dequantize_int8`` bitwise, and
  ``compressed_psum`` on a 4-rank mesh against the reference's per-rank
  arithmetic summed with numpy; the reference's error-feedback test.
* Elastic: ``shrink_after_failure`` against the reference's axis names and
  sizes; ``replace_state`` across meshes.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import sharding_rules as jax_rules
from repro.models.registry import build_model as jax_build_model
from repro.optim import compress as jax_compress
from repro.runtime import elastic as jax_elastic
from repro.runtime.sharding import planned_matmul_axes as jax_planned_matmul_axes
from repro_torch.configs import get_config
from repro_torch.dist import Mesh, _collectives, symmetric_matmul
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding_rules as rules
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, compress
from repro_torch.plan import planned_matmuls
from repro_torch.plan.lower_dist import block_slices
from repro_torch.runtime import elastic
from repro_torch.runtime.sharding import (NamedSharding, Placed, constrain, named_sharding,
                                          place, planned_matmul_axes, unplace, use_mesh)
from repro_torch.tree import tree_leaves, tree_paths

from test_plan import fake_mesh
from test_torch_dist_pg import WORLDS

MESHES = [((4,), ("model",)), ((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE_BATCH, CACHE_SEQ = 32, 64
GRAD_TOL = 2e-5


def _mesh_id(m):
    return "x".join(map(str, m[0])) + "-" + "".join(a[0] for a in m[1])


# -- specs -------------------------------------------------------------------------------


def _jax_key(path) -> str:
    return "//".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)


def _jax_flat(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {_jax_key(p): leaf for p, leaf in flat}


def _port_flat(tree, like=None):
    """{path: leaf} of a port tree; of a spec tree (tuples are its leaves)
    along the paths of ``like``, the tree it mirrors."""
    def at(t, path):
        for e in path:
            t = t[e]
        return t

    return {"//".join(map(str, p)): at(tree, p) for p, _ in tree_paths(
        tree if like is None else like)}


def _stacked_key(key: str) -> str:
    """A port path ``layers//3//attn//wq`` as the reference's stacked
    ``layers//attn//wq`` (unstacked paths as they are)."""
    parts = key.split("//")
    return "//".join(p for i, p in enumerate(parts) if not (i == 1 and p.isdigit()))


def _is_per_layer(key: str) -> bool:
    parts = key.split("//")
    return len(parts) > 1 and parts[1].isdigit()


def _spec(x) -> tuple:
    """A spec's entries, a one-axis tuple as its axis (``PartitionSpec``
    stores ``("data",)`` as ``"data"``; both cut the dim the same way)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in getattr(x, "spec", x))


def _is_spec(x) -> bool:
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.fixture(scope="module")
def trees():
    """arch -> (reference params, reference cache, port params, port cache),
    all abstract; and the reference's functions' input in the port's layout."""
    out = {}
    for arch in JAX_ARCHS:
        jm = jax_build_model(jax_get_config(arch))
        jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        jcache = jax.eval_shape(lambda: jm.init_cache(CACHE_BATCH, CACHE_SEQ))
        tm = build_model(get_config(arch))
        with FakeTensorMode():
            tparams = tm.init(torch.Generator(), "cpu")
            tcache = tm.init_cache(CACHE_BATCH, CACHE_SEQ, "cpu")
        # the port's tree as ShapeDtypeStructs, lists kept
        unstacked = jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                                 tparams)
        out[arch] = (jparams, jcache, tparams, tcache, unstacked)
    return out


def test_every_reference_config_has_a_tree(trees):
    assert sorted(trees) == sorted(JAX_ARCHS) and len(trees) == 10
    for arch, (jparams, jcache, tparams, tcache, _) in trees.items():
        port = {_stacked_key(k) for k in _port_flat(tparams)}
        assert port == set(_jax_flat(jparams)), arch
        assert {_stacked_key(k) for k in _port_flat(tcache)} == set(_jax_flat(jcache)), arch


def _compare_stacked(port_tree, ref_tree, what, like):
    port = _port_flat(port_tree, like)
    ref = _jax_flat(ref_tree, is_leaf=_is_spec)
    assert {_stacked_key(k) for k in port} == set(ref), what
    for key, got in port.items():
        want = _spec(ref[_stacked_key(key)])
        if _is_per_layer(key):
            assert want[:1] in ((), (None,)), (what, key, want)
            want = want[1:]
        assert _spec(got) == want, (what, key, _spec(got), want)


def _compare_same_layout(port_tree, ref_tree, what, like):
    port = _port_flat(port_tree, like)
    ref = _jax_flat(ref_tree, is_leaf=_is_spec)
    assert set(port) == set(ref), what
    for key, got in port.items():
        assert _spec(got) == _spec(ref[key]), (what, key, _spec(got), _spec(ref[key]))


@pytest.mark.parametrize("mesh_def", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_param_and_zero_specs_match_the_reference(trees, arch, mesh_def):
    jparams, _, tparams, _, unstacked = trees[arch]
    sizes, names = mesh_def
    jmesh = AbstractMesh(sizes, names)
    tmesh = fake_mesh(sizes, names)
    _compare_stacked(rules.param_specs(tparams), jax_rules.param_specs(jparams), "specs",
                     tparams)
    for auto in (False, True):
        _compare_stacked(rules.param_shardings(tparams, tmesh, auto_matmul=auto),
                         jax_rules.param_shardings(jparams, jmesh, auto_matmul=auto),
                         f"param_shardings auto={auto}", tparams)
        _compare_same_layout(rules.param_shardings(tparams, tmesh, auto_matmul=auto),
                             jax_rules.param_shardings(unstacked, jmesh, auto_matmul=auto),
                             f"param_shardings auto={auto}, port layout", tparams)
    _compare_same_layout(rules.zero_shardings(tparams, tmesh),
                         jax_rules.zero_shardings(unstacked, jmesh), "zero_shardings",
                         tparams)
    for ns in tree_leaves(rules.param_shardings(tparams, tmesh)):
        assert isinstance(ns, NamedSharding) and ns.mesh is tmesh


@pytest.mark.parametrize("mesh_def", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_cache_specs_match_the_reference(trees, arch, mesh_def):
    _, jcache, _, tcache, _ = trees[arch]
    sizes, names = mesh_def
    jmesh = AbstractMesh(sizes, names)
    tmesh = fake_mesh(sizes, names)
    for shard_batch in (True, False):
        _compare_stacked(rules.cache_shardings(tcache, tmesh, shard_batch=shard_batch),
                         jax_rules.cache_shardings(jcache, jmesh, shard_batch=shard_batch),
                         f"cache shard_batch={shard_batch}", tcache)


def test_a_rule_drops_an_axis_the_dimension_cannot_take():
    mesh = fake_mesh((16, 16), ("data", "model"))
    tree = {"layers": [{"attn": {"wq": torch.empty(64, 8), "wo": torch.empty(8, 64)}}],
            "moe": {"w_gate": torch.empty(6, 64, 32)}}
    sh = rules.param_shardings(tree, mesh)
    assert sh["layers"][0]["attn"]["wq"].spec == (None, None)     # 8 % 16
    assert sh["layers"][0]["attn"]["wo"].spec == (None, None)
    assert sh["moe"]["w_gate"].spec == (None, None, None)         # 6 experts % 16
    zero = rules.zero_shardings(tree, mesh)
    assert zero["layers"][0]["attn"]["wq"].spec == (("data",), None)


SHAPES_OF_TEST_PLAN = [((1024, 4096), (4,), ("model",)), ((4096, 1024), (4,), ("model",)),
                       ((64, 4096), (4,), ("model",)), ((4096,), (4,), ("model",)),
                       ((4098, 130), (4,), ("model",)), ((1024, 4096), (4,), ("data",))]


@pytest.mark.parametrize("shape, sizes, names", SHAPES_OF_TEST_PLAN)
def test_planned_matmul_axes_and_ranked_linear_spec_match_the_reference(shape, sizes, names):
    mesh = fake_mesh(sizes, names)
    assert rules.ranked_linear_spec(shape, mesh) == tuple(
        jax_rules.ranked_linear_spec(shape, mesh))
    if len(shape) == 2:
        assert planned_matmul_axes(*shape, mesh=mesh) == jax_planned_matmul_axes(
            *shape, mesh=mesh)
        with use_mesh(mesh):
            assert planned_matmul_axes(*shape) == jax_planned_matmul_axes(*shape, mesh=mesh)


def test_logical_axes_and_constrain():
    mesh = fake_mesh((2, 2, 2), ("pod", "data", "model"))
    ns = named_sharding(mesh, "batch", None, "model")
    assert ns.spec == (("pod", "data"), None, "model")
    x = torch.randn(4, 3, 2)
    assert constrain(x, "batch", None, "model") is x
    with use_mesh(mesh):
        assert constrain(x, "batch", None, "model") is x
        with pytest.raises(ValueError, match="not on mesh"):
            constrain(x, "expert")
    assert named_sharding(fake_mesh((4,), ("model",)), "batch", "model").spec == (None, "model")


def test_production_meshes_start_no_threads():
    for multi, sizes, names in ((False, (16, 16), ("data", "model")),
                                (True, (2, 16, 16), ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        assert mesh.axis_names == names and tuple(mesh.shape.values()) == sizes
        assert mesh._pool is None


# -- the planned backward -------------------------------------------------------------------

PRODUCT_SHAPES = {"2d": ((32,), 64, 48), "3d": ((2, 16), 64, 48), "ragged": ((30,), 27, 19)}
CASES = [(world, case) for world in sorted(WORLDS) for case in WORLDS[world]]


def _case_id(wc):
    world, (sizes, names, strategy, overlap) = wc
    return f"{strategy}-{'x'.join(map(str, sizes))}-ov{overlap}"


@pytest.fixture(scope="module")
def meshes():
    made = {}
    yield lambda sizes, names: made.setdefault((sizes, names),
                                               Mesh(sizes, names, device="cpu"))
    for m in made.values():
        m.close()


@pytest.mark.parametrize("shape", sorted(PRODUCT_SHAPES))
@pytest.mark.parametrize("wc", CASES, ids=[_case_id(c) for c in CASES])
def test_planned_gradients_match_jax_grad(meshes, wc, shape):
    _, (sizes, names, strategy, overlap) = wc
    lead, k, n = PRODUCT_SHAPES[shape]
    rng = np.random.default_rng(7)
    a = rng.standard_normal(lead + (k,), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    r = rng.standard_normal(lead + (n,), dtype=np.float32)
    ref = jax.grad(lambda x, y: jnp.vdot(jnp.matmul(x, y, precision="highest"), r),
                   argnums=(0, 1))(a, b)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    mesh = meshes(sizes, names)
    c = symmetric_matmul(ta, tb, mesh=mesh, strategy=strategy, overlap=overlap)
    assert c.grad_fn is not None and type(c.grad_fn).__name__ == "_PlannedMatmulBackward"
    da, db = torch.autograd.grad(c, (ta, tb), torch.from_numpy(r))
    for got, want in zip((da, db), ref):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.max(np.abs(got.numpy() - want)) <= GRAD_TOL * np.max(np.abs(want))


def test_a_planned_backward_plans_on_another_thread():
    """The backward reads its mesh from the autograd node, not from the
    plan scope: run in a thread of its own (where the scope is unset, as
    on autograd's device thread on CUDA), dA and dB are still planned."""
    import importlib

    lower_dist = importlib.import_module("repro_torch.plan.lower_dist")
    mesh = Mesh((2, 2), ("x", "y"), device="cpu")
    x = torch.randn(16, 32, requires_grad=True)
    w = torch.randn(32, 24, requires_grad=True)
    with planned_matmuls(mesh, strategy="summa"):
        from repro_torch.layers.linear import linear
        y = linear(x, w)
    lower_dist.reset_executions()
    out = {}
    t = threading.Thread(target=lambda: out.update(g=torch.autograd.grad(y.sum(), (x, w))))
    t.start()
    t.join(60)
    assert not t.is_alive()
    assert lower_dist.executions_snapshot() == {"summa+ov": 2}
    torch.testing.assert_close(out["g"][0], torch.ones(16, 24) @ w.detach().t())
    torch.testing.assert_close(out["g"][1], x.detach().t() @ torch.ones(16, 24))
    mesh.close()


# -- placement ---------------------------------------------------------------------------------

def test_a_block_is_its_slice_and_replicas_share_storage():
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec, distinct in (((None, "model"), 2), (("model", None), 2), ((), 1),
                           ((("data", "model"), None), 4), (("data", "model"), 4)):
        p = place(full, NamedSharding(mesh, spec))
        assert isinstance(p, Placed) and sorted(p) == [0, 1, 2, 3]
        for r in range(4):
            assert torch.equal(p[r], full[block_slices(full.shape, spec, mesh, r)])
            assert p[r].untyped_storage().data_ptr() != full.untyped_storage().data_ptr()
        assert len(p.distinct()) == distinct
        assert len({p[r].untyped_storage().data_ptr() for r in range(4)}) == distinct
        assert torch.equal(unplace(p), full)
    p = place(full, NamedSharding(mesh, (None, "model")))
    assert p[0] is p[2] and p[1] is p[3] and p[0] is not p[1]
    with pytest.raises(ValueError, match="does not split"):
        place(torch.zeros(3, 6), NamedSharding(mesh, ("data", None)))
    mesh.close()


def test_a_replicated_leaf_is_updated_once_and_counted_once():
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    rng = np.random.default_rng(3)
    w = {"norm": torch.from_numpy(rng.standard_normal(6, dtype=np.float32)),
         "wq": torch.from_numpy(rng.standard_normal((6, 8), dtype=np.float32))}
    g = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape), dtype=np.float32))
         for k, v in w.items()}
    plain = adamw.init(w)
    placed = elastic.replace_state(adamw.init(w), mesh)
    assert placed["master"]["norm"].sharding.spec == ()
    assert placed["master"]["wq"].sharding.spec == (None, "model")
    grads = [place(x, p.sharding) for x, p in zip(tree_leaves(g), tree_leaves(placed["master"]))]
    assert float(adamw.global_norm(grads)) == pytest.approx(float(adamw.global_norm(g)), rel=1e-6)
    lr = torch.tensor(0.1)
    for _ in range(3):
        adamw.step(plain, g, lr, adamw.AdamWConfig(clip_norm=1e9))
        adamw.step(placed, grads, lr, adamw.AdamWConfig(clip_norm=1e9))
    for key in ("master", "m", "v"):
        for want, got in zip(tree_leaves(plain[key]), tree_leaves(placed[key])):
            torch.testing.assert_close(unplace(got), want, rtol=0, atol=0)
    assert int(adamw.step_count(placed)) == 3
    mesh.close()


# -- compression -------------------------------------------------------------------------------

@pytest.mark.parametrize("shape, scale", [((256,), 1.0), ((64, 33), 1e-3), ((7,), 0.0),
                                          ((1000,), 50.0)])
def test_quantize_int8_is_the_references_bit_for_bit(shape, scale):
    x = (np.random.default_rng(11).standard_normal(shape) * scale).astype(np.float32)
    if x.size > 3:
        x.flat[:3] = np.float32(127.5 * scale)    # ties at the clip
    q, s = compress.quantize_int8(torch.from_numpy(x))
    jq, js = jax_compress.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    deq = compress.dequantize_int8(q, s).numpy()
    assert deq.tobytes() == np.asarray(jax_compress.dequantize_int8(jq, js)).tobytes()


def test_compressed_psum_matches_the_references_arithmetic():
    mesh = Mesh((4,), ("data",), device="cpu")
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((40, 3), dtype=np.float32) * (r + 1) for r in range(4)]
    res = [rng.standard_normal((40, 3), dtype=np.float32) * 1e-3 for r in range(4)]
    _collectives.reset_stats()
    outs = mesh.run(lambda x, r: compress.compressed_psum(x, "data", r),
                    {r: (torch.from_numpy(xs[r]), torch.from_numpy(res[r])) for r in range(4)})
    # the reference's per-rank arithmetic, its psums as numpy sums
    qs, scales, new_res = [], [], []
    for x, r in zip(xs, res):
        xf = jnp.asarray(x) + jnp.asarray(r)
        q, s = jax_compress.quantize_int8(xf)
        new_res.append(np.asarray(xf - jax_compress.dequantize_int8(q, s)))
        qs.append(np.asarray(q, np.int32))
        scales.append(np.asarray(s))
    summed = np.sum(qs, axis=0).astype(np.float32)
    mean = summed * (np.float32(np.sum(scales, dtype=np.float32)) / np.float32(4)) / np.float32(4)
    for r in range(4):
        got, got_res = outs[r]
        np.testing.assert_allclose(got.numpy(), mean, rtol=1e-6, atol=0)
        assert got_res.numpy().tobytes() == new_res[r].tobytes()
    # three psums a rank: the int32 codes, the scale, the count
    assert _collectives.stats["psum"]["calls"] == 12
    assert _collectives.stats["psum"]["bytes"] == 4 * 3 * (40 * 3 * 4 + 4 + 4)
    grads = {"a": [torch.ones(5)], "b": torch.zeros(2, dtype=torch.bfloat16)}
    zero = {"a": [torch.zeros(5)], "b": torch.zeros(2)}
    out = mesh.run(lambda g, r: compress.compress_tree_psum(g, "data", r),
                   {r: (grads, zero) for r in range(4)})
    red, nres = out[0]
    assert torch.equal(red["a"][0], torch.ones(5)) and red["b"].dtype == torch.bfloat16
    assert torch.equal(nres["a"][0], torch.zeros(5))
    mesh.close()


def test_error_feedback_unbiased():
    """The reference's ``TestCompression.test_error_feedback_unbiased`` on
    the port, with the reference's gradients."""
    key = jax.random.PRNGKey(1)
    residual = torch.zeros(64)
    acc_true = torch.zeros(64)
    acc_q = torch.zeros(64)
    for _ in range(50):
        key, sub = jax.random.split(key)
        g = torch.from_numpy(np.array(jax.random.normal(sub, (64,)) * 0.1))
        acc_true += g
        x = g + residual
        q, s = compress.quantize_int8(x)
        deq = compress.dequantize_int8(q, s)
        residual = x - deq
        acc_q += deq
    drift = float(torch.max(torch.abs(acc_q + residual - acc_true)))
    assert drift < 1e-4


# -- elastic -----------------------------------------------------------------------------------

@pytest.mark.parametrize("sizes, names, lost", [((2, 2, 2), ("pod", "data", "model"), 1),
                                                ((3, 1, 2), ("pod", "data", "model"), 0),
                                                ((3, 2), ("pod", "model"), 2)])
def test_shrink_after_failure_gives_the_references_mesh(sizes, names, lost):
    # the reference's shrink reads the axis names, the shape and the device
    # grid of a concrete mesh; a grid of placeholders stands in for devices
    from jax.sharding import Mesh as JaxMesh

    jmesh = JaxMesh(np.arange(int(np.prod(sizes))).reshape(sizes), names)
    want = jax_elastic.shrink_after_failure(jmesh, lost_pod=lost)
    got = elastic.shrink_after_failure(elastic.make_mesh(sizes, names, device="cpu"), lost)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)


def test_shrink_without_a_pod_axis_raises_as_the_reference():
    from jax.sharding import Mesh as JaxMesh

    with pytest.raises(ValueError, match="no pod axis to shrink"):
        jax_elastic.shrink_after_failure(JaxMesh(np.arange(4).reshape(2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="no pod axis to shrink"):
        elastic.shrink_after_failure(elastic.make_mesh((2, 2), ("data", "model"), device="cpu"))


def test_replace_state_moves_a_state_between_meshes():
    """The reference's ``test_elastic_remesh_state_roundtrip`` on the port."""
    state = {"step": torch.tensor(7, dtype=torch.int32),
             "master": {"wq": torch.arange(64, dtype=torch.float32).reshape(8, 8)},
             "m": {"wq": torch.ones(8, 8)}, "v": {"wq": torch.ones(8, 8)}}
    mesh2 = elastic.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    st2 = elastic.replace_state(state, mesh2)
    assert st2["master"]["wq"].sharding.spec == (None, "model")
    surv = elastic.shrink_after_failure(mesh2, lost_pod=1)
    assert "pod" not in surv.axis_names and surv.size == 4
    st1 = elastic.replace_state(st2, surv)
    assert st1["master"]["wq"].sharding.mesh is surv
    assert torch.equal(unplace(st1["master"]["wq"]), state["master"]["wq"])
    assert int(adamw.step_count(st1)) == 7
