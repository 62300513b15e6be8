"""The benchmark's arithmetic against hand counts at smoke sizes, and its
list of products against the products the program runs."""
from __future__ import annotations

from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import weights, work

DENSE = {"name": "dense-smoke", "family": "dense", "num_layers": 2, "d_model": 64,
         "num_heads": 4, "num_kv_heads": 2, "d_ff": 128, "vocab_size": 256, "head_dim": 16,
         "window": 24, "attn_chunk": 32, "dtype": "bfloat16"}
MOE = {"name": "moe-smoke", "family": "moe", "num_layers": 3, "d_model": 64, "num_heads": 4,
       "num_kv_heads": 4, "d_ff": 128, "vocab_size": 256, "head_dim": 16, "num_experts": 8,
       "num_shared_experts": 1, "top_k": 2, "moe_d_ff": 48, "first_dense_layers": 1,
       "moe_group_size": 32, "attn_chunk": 32, "dtype": "bfloat16"}


def test_linear_products_by_hand():
    p = work.linear_products(DENSE, 10, 10)
    assert len(p) == 2 * 7 + 1
    assert p[0] == (10, 64, 64, 2) and p[-1] == (10, 64, 256, 4)
    flops = sum(2 * m * k * n for m, k, n, _ in p)
    layer = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128
    assert flops == 2 * (2 * 10 * layer) + 2 * 10 * 64 * 256
    q_bytes = (10 * 64 + 64 * 64) * 2 + 10 * 64 * 2
    assert work.product_bound_s(p[0]) == pytest.approx(max(2 * 10 * 64 * 64 / 989e12,
                                                           q_bytes / 3.35e12))


def test_attention_pairs_by_hand():
    assert work.attention_pairs(5, 5, True, 0) == 15
    assert work.attention_pairs(5, 5, True, 2) == 9
    assert work.attention_pairs(5, 5, False, 0) == 25
    i, j = np.meshgrid(np.arange(40), np.arange(40), indexing="ij")
    assert work.attention_pairs(40, 40, True, 7) == int(((j <= i) & (j > i - 7)).sum())


def test_model_flops_by_hand():
    per_token = 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128)
    assert work.token_params(DENSE) == per_token
    assert work.prefill_flops(DENSE, 8) == (2 * 8 * per_token + 4 * 16 * 4 * 36 * 2
                                            + 2 * 8 * 64 * 256)
    assert work.served_flops(DENSE, 3, 2) == (2 * 4 * per_token + 4 * 16 * 4 * 10 * 2
                                              + 2 * 2 * 64 * 256)
    attn = 64 * 64 + 2 * 64 * 64 + 64 * 64   # q, k, v, o with 4 kv heads of 16
    assert work.token_params(MOE) == ((attn + 3 * 64 * 128)
                                      + 2 * (attn + 64 * 8 + 3 * 64 * 48 * 3))


@pytest.mark.parametrize("m", [DENSE, MOE], ids=["dense", "moe"])
@pytest.mark.parametrize("rows", [1, 4])
def test_products_are_the_programs(m, rows):
    """The products ``work.linear_products`` prices are the ones the
    program's ``linear`` and ``unembed`` run in a decode step at ``rows``
    rows (the unembedding in fp32)."""
    from repro_torch.layers import embed, linear
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.lm import DecoderLM

    seen = Counter()
    real_mm, real_k1 = linear.local_matmul, embed.matmul

    def mm(x, w, **kw):
        seen[(x.numel() // x.shape[-1], w.shape[0], w.shape[1], 2)] += 1
        return real_mm(x, w, **kw)

    def k1(a, b, **kw):
        seen[(a.shape[0], a.shape[1], b.shape[1], kw["out_dtype"].itemsize)] += 1
        return real_k1(a, b, **kw)

    params = weights.program_tree(weights.make(m, 3, "cpu"))
    model = DecoderLM(ModelConfig(**m))
    cache = model.init_cache(rows, 8, "cpu")
    with mock.patch.object(linear, "local_matmul", mm), mock.patch.object(embed, "matmul", k1), \
            torch.no_grad():
        model.decode_step(params, cache, torch.ones(rows, 1, dtype=torch.int64), 0)
    assert seen == Counter(work.linear_products(m, rows, rows))
