"""Token embedding + LM head over a vocabulary padded to a multiple of 256.

Padded logit columns are masked to -1e30, so argmax and cross-entropy over
the padded width are exact (as in ``repro.layers.embed``).
"""
from __future__ import annotations

from typing import Dict

import torch

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

    A plain ``torch.matmul`` on fp32 operands (the reference leaves this
    product to XLA, outside the Pallas kernel); bf16 weights are exact in
    fp32, so this is the reference's fp32-accumulating product."""
    w = p.get("lm_head")
    if w is None:
        w = p["embedding"].t()
    logits = torch.matmul(x.float(), w.float())
    vp = logits.shape[-1]
    if vp != vocab:
        logits[..., vocab:] = _NEG
    return logits
