"""Token embedding + LM head over a vocabulary padded to a multiple of 256.

Padded logit columns are masked to -1e30, so argmax and cross-entropy over
the padded width are exact (as in ``repro.layers.embed``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import obs
from repro_torch.kernels.matmul.ops import matmul

Params = Dict[str, torch.Tensor]

VOCAB_ALIGN = 256
_NEG = -1e30


def padded_vocab(vocab: int, align: int = VOCAB_ALIGN) -> int:
    return (vocab + align - 1) // align * align


def embed_params(generator: torch.Generator, vocab: int, d: int, tie: bool,
                 dtype: torch.dtype, device) -> Params:
    vp = padded_vocab(vocab)
    gdev = generator.device

    def normal(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=gdev)
        return (w * 0.02).to(device=device, dtype=dtype)

    p = {"embedding": normal((vp, d))}
    if not tie:
        p["lm_head"] = normal((d, vp))
    return p


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def unembed(p: Params, x: torch.Tensor, vocab: int) -> torch.Tensor:
    """fp32 logits over the padded vocab, padded columns at -1e30.

    The reference's ``jnp.matmul(x, w, preferred_element_type=f32)``: the
    operands in their own type (bf16 in a bf16 model), fp32 accumulation
    and output.  Here one K1 launch on the folded rows, never through the
    plan engine (the reference leaves it to XLA); a tied table is read in
    place through its ``.t()`` view, so no copy of the head is made.
    Operands of two types meet in the wider one, as ``jnp.matmul``
    promotes them."""
    with obs.span("layer.unembed"):
        w = p.get("lm_head")
        if w is None:
            w = p["embedding"].t()
        dt = torch.promote_types(x.dtype, w.dtype)
        rows = x.reshape(-1, x.shape[-1]).to(dt).contiguous()
        logits = matmul(rows, w.to(dt), out_dtype=torch.float32)
        logits = logits.reshape(*x.shape[:-1], w.shape[1])
        vp = logits.shape[-1]
        if vp != vocab:
            logits[..., vocab:] = _NEG
        return logits
