"""K2's routing, TMA geometry and key-tile walk, on the CPU.

The kernels need the card, but what decides which kernel runs and what it
reads is plain Python in ``repro_torch.kernels.flash_attention.kernel``:
``route`` and ``select_route`` (the route of a call), ``tma_geometry`` (the
4-D tensor maps the wgmma route reads q, k and v through) and ``kv_tiles``
(the mirror of the kernels' ``kv_range`` and ``tile_needs_mask``).  The
walk is held pair by pair against the plain version's mask rule, and that
rule against ``attention_ref`` itself, read off with one-hot values.  No
JAX here: none is needed.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.kernels.matmul import _build as k1_build

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("d, dtype, aligned, want", [
    (56, BF16, True, "mma"), (64, BF16, True, "wgmma"), (120, BF16, True, "wgmma"),
    (128, BF16, True, "wgmma"), (136, BF16, True, "mma"), (100, BF16, True, "mma"),
    (64, BF16, False, "mma"), (120, BF16, False, "mma"),
    (56, F32, True, "fma"), (64, F32, True, "fma"), (120, F32, True, "fma"),
    (128, F32, True, "fma"), (136, F32, True, "fma"), (120, F32, False, "fma"),
])
def test_route_at_each_boundary(d, dtype, aligned, want):
    assert k2.route(d, dtype, aligned) == want
    assert k2.select_route(d, dtype, aligned) == want


@pytest.mark.parametrize("d, dtype, aligned, forced, match", [
    (32, BF16, True, "wgmma", "wgmma route takes"),
    (120, BF16, False, "wgmma", "wgmma route takes"),
    (120, F32, True, "wgmma", "wgmma route takes torch.bfloat16"),
    (120, BF16, True, "fma", "fma route takes torch.float32"),
    (64, F32, True, "mma", "mma route takes torch.bfloat16"),
    (64, BF16, True, "tma", "unknown route"),
])
def test_forced_route_refuses_what_it_cannot_take(d, dtype, aligned, forced, match):
    with pytest.raises(ValueError, match=match):
        k2.select_route(d, dtype, aligned, forced)


def test_forced_route_is_taken_where_it_can_run():
    assert k2.select_route(120, BF16, True, "mma") == "mma"    # the old route at danube's D
    assert k2.select_route(64, BF16, True, "wgmma") == "wgmma"
    assert k2.select_route(32, F32, False, "fma") == "fma"


def test_aligned_reads_bases_and_strides():
    x = torch.zeros(2, 40, 4, 64, dtype=BF16)
    assert k2.aligned(x, x[:, :, 1:3], x[:, 8:])          # head and sequence slices
    shifted = torch.zeros(2 * 40 * 4 * 64 + 8, dtype=BF16)[1:1 + 2 * 40 * 4 * 64]
    assert not k2.aligned(shifted.view(2, 40, 4, 64))     # a base 2 bytes off 16
    odd = torch.zeros(1, 40, 4, 68, dtype=BF16)[..., :64]  # rows 68 elements apart
    assert not k2.aligned(odd)
    one_row = torch.zeros(1, 1, 3, 64, dtype=BF16)         # an extent-1 dim's stride is moot
    assert k2.aligned(one_row.as_strided(one_row.shape, (3, 1, 64, 1)))


@pytest.mark.parametrize("dim", [0, 2])
def test_a_broadcast_dim_goes_to_the_mma_route(dim):
    """An expanded (stride 0) batch or head: TMA takes no stride of 0, the
    mma route's copies do, so the call routes to mma and the mma check
    passes it."""
    shape = [2, 40, 4, 120]
    one = torch.zeros(*[1 if i == dim else n for i, n in enumerate(shape)], dtype=BF16)
    wide = one.expand(*shape)
    assert wide.stride(dim) == 0
    q = torch.zeros(*shape, dtype=BF16)
    assert not k2.aligned(q, wide, wide)
    assert k2.aligned(q, wide, wide, tma=False)
    assert k2.route(120, BF16, k2.aligned(q, wide, wide)) == "mma"
    with pytest.raises(ValueError, match="wgmma route takes"):
        k2.select_route(120, BF16, k2.aligned(q, wide, wide), "wgmma")
    odd = torch.zeros(2, 40, 4, 68, dtype=BF16)[..., :64]
    assert not k2.aligned(odd, tma=False)               # a stride of 68 fails either way


def _bshd(x):  # (BH, S, D) -> the (1, S, BH, D) view flash_attention launches on
    return x.unsqueeze(0).transpose(1, 2)


@pytest.mark.parametrize("what", ["bshd", "bh_s_d", "head_slice"])
def test_tma_geometry_of_each_layout(what):
    if what == "bshd":        # the model's contiguous (B, S, H, D)
        t, box, want = torch.zeros(2, 300, 8, 120, dtype=BF16), 128, \
            (120, 8, 300, 2, 240, 8 * 240, 300 * 8 * 240, 64, 1, 128, 1)
    elif what == "bh_s_d":    # the reference's (BH, S, D), one batch of BH heads
        t, box, want = _bshd(torch.zeros(64, 300, 64, dtype=BF16)), 128, \
            (64, 64, 300, 1, 300 * 128, 128, 128, 64, 1, 128, 1)
    else:                     # k of a fused (B, S, H_q + 2 H_kv, D) tensor
        t, box, want = torch.zeros(3, 50, 48, 80, dtype=BF16)[:, :, 32:40], 128, \
            (80, 8, 50, 3, 160, 48 * 160, 50 * 48 * 160, 64, 1, 128, 1)
    assert k2.tma_geometry(t.shape, t.stride(), box) == want
    dims, strides, boxes = want[:4], want[4:7], want[7:]
    assert dims == (t.shape[3], t.shape[2], t.shape[1], t.shape[0])
    for n, elems, nbytes in zip(dims[1:], (t.stride(2), t.stride(1), t.stride(0)), strides):
        assert nbytes == (elems * 2 if n > 1 else dims[0] * 2) and nbytes % 16 == 0
    assert boxes == (k2.TMA_BOX_D, 1, box, 1)


@pytest.mark.parametrize("shape, strides, box, match", [
    ((1, 64, 2, 120), (15360, 240, 120, 2), 128, "contiguous"),
    ((1, 64, 2, 56), (7168, 112, 56, 1), 128, "head dim 56"),
    ((1, 64, 2, 136), (17408, 272, 136, 1), 128, "head dim 136"),
    ((1, 64, 2, 100), (12800, 200, 100, 1), 128, "head dim 100"),
    ((1, 64, 2, 120), (15360, 244, 120, 1), 128, "seq stride"),      # 488 bytes
    ((2, 64, 2, 120), (15364, 240, 120, 1), 128, "batch stride"),
    ((1, 64, 3, 120), (15360, 360, 0, 1), 128, "head stride"),       # an expanded head
    ((1, 0, 2, 120), (0, 240, 120, 1), 128, "extents"),
    ((1, 64, 2, 120), (15360, 240, 120, 1), 0, "box"),
    ((1, 64, 2, 120), (15360, 240, 120, 1), 300, "box"),
    ((2, 64, 2, 120), (2 ** 39, 240, 120, 1), 128, "batch stride"),   # 2^40 bytes
])
def test_tma_geometry_refusals(shape, strides, box, match):
    with pytest.raises(ValueError, match=match):
        k2.tma_geometry(shape, strides, box)


def _valid_keys(sq, skv, causal, window):
    """attention_ref's mask rule, pair by pair: key j < S_kv is valid for
    query i when j <= i (causal) and j > i - window (window > 0)."""
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    ok = np.broadcast_to(j < skv, (sq, skv)).copy()
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= j > i - window
    return ok


@pytest.mark.parametrize("sq, skv, causal, window", [
    (300, 300, True, 64), (200, 90, True, 16), (90, 200, False, 30), (150, 150, False, 0)])
def test_mask_rule_is_attention_refs(sq, skv, causal, window):
    """Read off attention_ref itself: equal scores and one-hot values give
    row i a uniform weight on exactly its valid keys (and 0 everywhere for
    a row with none)."""
    out = attention_ref(torch.zeros(1, sq, 1), torch.zeros(1, skv, 1), torch.eye(skv)[None],
                        causal=causal, window=window)[0].numpy()
    np.testing.assert_array_equal(out > 0, _valid_keys(sq, skv, causal, window))


# (S_q, S_kv, causal, window): causal alone, windows 200, 4032 and 4096 on
# ragged lengths, S_q > S_kv (rows with no key), S_q < S_kv, non-causal;
# windows of 255 and 383 put a tile's first key exactly one window before
# the tile's last row, the edge of tile_needs_mask's window test
WALKS = [(700, 700, True, 0), (1000, 1000, True, 200), (4400, 4400, True, 4032),
         (4400, 4300, True, 4096), (900, 300, True, 200), (300, 900, True, 0),
         (520, 700, False, 100), (300, 1000, False, 0), (1, 1, True, 0),
         (1000, 1000, True, 255), (600, 700, False, 383)]


@pytest.mark.parametrize("walk", WALKS, ids=lambda w: "-".join(map(str, w)))
def test_kv_tiles_hold_every_valid_pair_and_mask_every_invalid_one(walk):
    sq, skv, causal, window = walk
    valid = _valid_keys(sq, skv, causal, window)
    bm, bn = k2.BLOCK_M, k2.BLOCK_N
    assert (bm, bn) == (128, 128)
    for q0 in range(0, sq, bm):
        rows = valid[q0:q0 + bm]
        tiles = k2.kv_tiles(q0, sq, skv, causal, window)
        starts = [j0 for j0, _ in tiles]
        assert starts == list(range(starts[0], starts[0] + bn * len(starts), bn)) if tiles \
            else not rows.any()
        covered = np.zeros(skv, bool)
        for j0, masked in tiles:
            assert j0 % bn == 0 and 0 <= j0 < skv
            covered[j0:j0 + bn] = True
            if not masked:     # run without a mask: every pair in the tile is valid
                assert j0 + bn <= skv and rows[:, j0:j0 + bn].all(), (q0, j0)
        assert not (rows & ~covered).any(), q0     # no valid pair left out


def test_kv_tiles_at_danubes_shape():
    """32 unmasked tiles between two masked ones once the 4096 window is
    full; the first query tile has only its causal tile."""
    tiles = k2.kv_tiles(8192, 32768, 32768, True, 4096)
    assert len(tiles) == 33 and [m for _, m in tiles] == [True] + [False] * 31 + [True]
    assert k2.kv_tiles(0, 32768, 32768, True, 4096) == [(0, True)]


def test_shared_headers_are_in_both_kernels_builds(tmp_path, monkeypatch):
    """hopper.cuh is hashed into K1's and K2's library names, so an edit to
    it rebuilds both kernels."""
    for kern in (k1_build.KERNEL, k2.KERNEL):
        assert "hopper.cuh" in [s.name for s in _build.sources(kern)]
    assert "flash_common.cuh" in [s.name for s in _build.sources(k2.KERNEL)]
    before = {kern.name: _build.library_path(kern) for kern in (k1_build.KERNEL, k2.KERNEL)}
    edited = tmp_path / "common"
    edited.mkdir()
    src = Path(_build.COMMON) / "hopper.cuh"
    (edited / "hopper.cuh").write_text(src.read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "COMMON", edited)
    for kern in (k1_build.KERNEL, k2.KERNEL):
        assert _build.library_path(kern) != before[kern.name]


def test_flash_attention_bshd_refuses_cpu_tensors_and_counts_nothing():
    q = torch.zeros(1, 8, 2, 64, dtype=BF16)
    k2.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        k2.flash_attention_bshd(q, q, q, route="wgmma")
    assert k2.launches == 0 and set(k2.launches_by_route) == set(k2.ROUTES)
    assert not any(k2.launches_by_route.values())
