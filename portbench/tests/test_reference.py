"""The plain references against the program, on the CPU at smoke sizes.

In float32 the program and the reference compute the same equations, so
their logits agree to rounding: an uncached forward, and a served batch
(left-padded prompts in a bucket, prefill, then the served tokens fed back
one a step) on the dense and the MoE decoder.  The MoE case routes with a
capacity small enough that tokens are dropped, padding queries included,
so the reference's routing groups and its padding queries are held to the
program's.  This file imports the program; ``portbench/reference`` does not.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import decoder
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import DecoderLM

DENSE = {"name": "dense-smoke", "family": "dense", "num_layers": 2, "d_model": 64,
         "num_heads": 4, "num_kv_heads": 2, "d_ff": 128, "vocab_size": 256, "head_dim": 16,
         "window": 24, "rope_theta": 100000.0, "attn_chunk": 32, "dtype": "float32"}
MOE = {"name": "moe-smoke", "family": "moe", "num_layers": 3, "d_model": 64, "num_heads": 4,
       "num_kv_heads": 4, "d_ff": 128, "vocab_size": 256, "head_dim": 16, "num_experts": 8,
       "num_shared_experts": 1, "top_k": 2, "moe_d_ff": 48, "first_dense_layers": 1,
       "moe_group_size": 16, "capacity_factor": 1.0, "attn_chunk": 32, "dtype": "float32"}
TOL = 1e-4   # float32 against float32: the same sums in other orders


def _model(m):
    return DecoderLM(ModelConfig(**m))


def test_prefill_logits_match_the_program():
    m = dict(DENSE, attn_impl="xla")
    params = weights.make(m, 5, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, 96))
    with torch.no_grad():
        want, _ = _model(m).forward(weights.program_tree(params), tokens[None])
    got = decoder.prefill_logits(params, m, tokens, chunk=40)
    assert (got - want[0]).abs().max() < TOL * want.abs().max()


@pytest.mark.parametrize("m", [dict(DENSE, window=0), MOE], ids=["dense", "moe"])
def test_served_logits_match_the_program(m):
    plen, new, max_seq = 32, 6, 40
    params = weights.make(m, 7, "cpu")
    tree = weights.program_tree(params)
    model = _model(m)
    rng = np.random.default_rng(1)
    lens = [3, 17, 32, 9]
    prompts = torch.zeros(len(lens), plen, dtype=torch.int64)
    for i, n in enumerate(lens):
        prompts[i, plen - n:] = torch.from_numpy(rng.integers(0, 256, n))
    offsets = torch.tensor([plen - n for n in lens])
    fed = torch.from_numpy(rng.integers(0, 256, (len(lens), new - 1)))
    want = []
    with torch.no_grad():
        cache = model.init_cache(len(lens), max_seq, "cpu")
        logits, _ = model.prefill(tree, cache, prompts, offsets)
        want.append(logits)
        for t in range(new - 1):
            pos = torch.tensor(plen + t)
            logits, _ = model.decode_step(tree, cache, fed[:, t:t + 1], pos, offsets)
            want.append(logits)
    want = torch.stack(want, dim=1)
    got = decoder.served_logits(params, m, prompts, offsets, fed, max_seq)
    assert (got - want).abs().max() < TOL * want.abs().max()


def test_capacity_drops_tokens_in_the_moe_case():
    """The MoE case above is only a test of the routing if some choice is
    dropped: at capacity 1.0 in groups of 16 some expert overflows."""
    m = MOE
    params = weights.make(m, 7, "cpu")
    x = torch.randn(2, 32, m["d_model"], generator=torch.Generator().manual_seed(0))
    w = decoder._fp32(params["layers"][0]["moe"])
    _, _, kept = decoder.route(x, w, m, [(0, 32, 16)], fp8=False)
    assert not kept.all()
