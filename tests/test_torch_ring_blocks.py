"""The port's ring-TP MLP block against the unsharded data flow, on a
4-rank thread mesh on the CPU.

As ``tests/test_ring_blocks.py`` holds the reference: the per-rank
program's output, gathered along the sequence, within 2e-5 (max abs) of
``gspmd_mlp_reference``, and its collectives are permute chains only: the
interceptor (``repro_torch.verify.intercept``) records ``ppermute`` calls
and no ``all_gather`` or ``psum``.  The weights and the input are the
reference test's shapes (B 2, S 32, d 16, f 48), from a seeded numpy
generator; the JAX function is run on the same arrays as a second oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers.ring_blocks import gspmd_mlp_reference as jax_gspmd_mlp_reference
from repro_torch.dist import Mesh
from repro_torch.layers.ring_blocks import gspmd_mlp_reference, ring_mlp
from repro_torch.verify import intercept

TOL = 2e-5
B, S, D, F = 2, 32, 16, 48
T = 4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    p = {k: rng.standard_normal(shape, dtype=np.float32) * 0.1
         for k, shape in (("w_gate", (D, F)), ("w_up", (D, F)), ("w_down", (F, D)))}
    return x, p


def _run_ring(x, p, tp_axis="model"):
    """ring_mlp on T rank threads: rank r holds x's r-th sequence chunk and
    the r-th column (row, for w_down) shard of each weight."""
    mesh = Mesh((T,), (tp_axis,), device="cpu")
    s_loc, f_loc = S // T, F // T

    def shard(a, *index):
        return torch.from_numpy(np.ascontiguousarray(a[index]))

    cols = [slice(r * f_loc, (r + 1) * f_loc) for r in range(T)]
    args = {r: ({"w_gate": shard(p["w_gate"], slice(None), cols[r]),
                 "w_up": shard(p["w_up"], slice(None), cols[r]),
                 "w_down": shard(p["w_down"], cols[r])},
                shard(x, slice(None), slice(r * s_loc, (r + 1) * s_loc)), tp_axis)
            for r in range(T)}
    try:
        with intercept() as cap:
            outs = mesh.run(ring_mlp, args)
    finally:
        mesh.close()
    return torch.cat([outs[r] for r in range(T)], dim=1), cap


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_mlp_matches_gspmd_and_uses_permutes(seed):
    x, p = _inputs(seed)
    ref = gspmd_mlp_reference({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x))
    out, cap = _run_ring(x, p)
    assert out.shape == (B, S, D) and out.dtype == torch.float32
    assert (out - ref).abs().max().item() < TOL
    kinds = [r.kind for r in cap.records]
    assert cap.ranks == tuple(range(T)) and cap.divergence() is None
    # two ring all-gathers and one ring reduce-scatter, T - 1 hops each
    assert kinds.count("ppermute") == 3 * (T - 1)
    assert kinds.count("all_gather") == 0 and kinds.count("psum") == 0


def test_plain_data_flow_is_the_references():
    """``gspmd_mlp_reference`` equals the JAX function on the same arrays,
    in fp32 and in bf16 (each product rounded to bf16 as there)."""
    x, p = _inputs(2)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-6), (torch.bfloat16, jnp.bfloat16,
                                                              1e-2)):
        ref = jax_gspmd_mlp_reference({k: jnp.asarray(v, jdt) for k, v in p.items()},
                                      jnp.asarray(x, jdt))
        out = gspmd_mlp_reference({k: torch.from_numpy(v).to(dt) for k, v in p.items()},
                                  torch.from_numpy(x).to(dt))
        ref = np.asarray(ref.astype(jnp.float32))
        assert out.dtype == dt
        scale = np.abs(ref).max()
        assert np.abs(out.float().numpy() - ref).max() <= tol * scale


def test_ring_mlp_on_another_axis_name():
    """The ring axis is the one named: a mesh axis called ``tp``."""
    x, p = _inputs(3)
    out, cap = _run_ring(x, p, tp_axis="tp")
    ref = gspmd_mlp_reference({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x))
    assert (out - ref).abs().max().item() < TOL
    assert {r.kind for r in cap.records} == {"ppermute"}
