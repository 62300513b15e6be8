"""The benchmark's arithmetic: operations and bytes from a configuration's
shapes, and the card's published peaks they are priced at.

Everything here is computed from the sizes in a configuration file
(``configs/<name>.json``'s ``model``), never from what the program counts,
so a change to the program cannot move the yardstick.  A product's bound
is the least time the card could take: the larger of its operations at the
bf16 tensor-core peak and its bytes (each operand read once, the output
written once) at the memory rate.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

# NVIDIA H100 SXM5 80GB data sheet, dense rates at 700 W
PEAK_FLOPS = 989e12       # bf16 on the tensor cores, FLOP/s
PEAK_BYTES_S = 3.35e12    # HBM3, B/s
BF16, FP32 = 2, 4         # bytes an element

Product = Tuple[int, int, int, int]    # (m, k, n, bytes of an output element)


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def padded_vocab(vocab: int, align: int = 256) -> int:
    return (vocab + align - 1) // align * align


def stacks(m: Dict) -> List[Tuple[str, int]]:
    """(block kind, layers) in the order the layers run: the leading dense
    layers, then the rest (MoE where the model has experts)."""
    nd = m.get("first_dense_layers", 0)
    kind = "moe" if m.get("num_experts") else "mlp"
    return ([("mlp", nd)] if nd else []) + [(kind, m["num_layers"] - nd)]


def linear_products(m: Dict, rows: int, unembed_rows: int) -> List[Product]:
    """Every product that goes through the program's ``linear`` (attention's
    q, k, v, o; the dense MLP's or the shared experts' gate, up and down)
    for ``rows`` tokens, and the unembedding of ``unembed_rows`` rows into
    fp32 logits."""
    d, h, kv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], head_dim(m)
    out: List[Product] = []
    for kind, n in stacks(m):
        ff = m["d_ff"] if kind == "mlp" else m["moe_d_ff"] * m.get("num_shared_experts", 0)
        layer = [(rows, d, h * hd, BF16), (rows, d, kv * hd, BF16), (rows, d, kv * hd, BF16),
                 (rows, h * hd, d, BF16)]
        if ff:
            layer += [(rows, d, ff, BF16), (rows, d, ff, BF16), (rows, ff, d, BF16)]
        out += layer * n
    out.append((unembed_rows, d, padded_vocab(m["vocab_size"]), FP32))
    return out


def product_bound_s(p: Product) -> float:
    """Least seconds for one bf16 product: 2 m k n operations at the peak, or
    A and B read once and C written once at the memory rate."""
    mm, k, n, out_bytes = p
    flops = 2.0 * mm * k * n
    nbytes = (mm * k + k * n) * BF16 + mm * n * out_bytes
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def products_bound_s(products: Iterable[Product]) -> float:
    return sum(product_bound_s(p) for p in products)


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head, query i and key j counted
    from 0: j <= i when causal, j > i - window when window > 0."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, i + 1) if causal else np.full(sq, skv, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound_s(m: Dict, batch: int, seq: int) -> float:
    """Least seconds for one layer's causal attention core over ``seq``
    tokens within the window: 4 head-dim operations per valid pair and
    query head, or Q, K, V read once and O written once (bf16)."""
    h, kv, hd = m["num_heads"], m["num_kv_heads"], head_dim(m)
    flops = 4.0 * hd * batch * h * attention_pairs(seq, seq, True, m.get("window", 0))
    nbytes = 2.0 * batch * hd * (seq * h + seq * kv) * BF16
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def token_params(m: Dict) -> int:
    """Weights one token multiplies by in the layers (attention, the dense
    MLP or the router, the top-k and shared experts), without the
    embedding and the unembedding."""
    d, h, kv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], head_dim(m)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    total = 0
    for kind, n in stacks(m):
        if kind == "mlp":
            ffn = 3 * d * m["d_ff"]
        else:
            ffn = (d * m["num_experts"]
                   + 3 * d * m["moe_d_ff"] * (m["top_k"] + m.get("num_shared_experts", 0)))
        total += n * (attn + ffn)
    return total


def attention_flops(m: Dict, pairs: int) -> float:
    """QKᵀ and PV over ``pairs`` (query, key) pairs, every layer and head."""
    return 4.0 * head_dim(m) * m["num_heads"] * pairs * m["num_layers"]


def prefill_flops(m: Dict, seq: int) -> float:
    """Model operations of one forward over ``seq`` tokens with logits for
    every position."""
    pairs = attention_pairs(seq, seq, True, m.get("window", 0))
    return (2.0 * seq * token_params(m) + attention_flops(m, pairs)
            + 2.0 * seq * m["d_model"] * m["vocab_size"])


def served_flops(m: Dict, prompt: int, new_tokens: int) -> float:
    """Model operations of serving one request: its prompt's tokens once,
    then ``new_tokens - 1`` decode steps, each attending to its context
    within the window; logits for the prompt's last token and each step."""
    window = m.get("window", 0)
    tokens = prompt + max(new_tokens - 1, 0)
    ctx = np.arange(1, tokens + 1, dtype=np.int64)
    pairs = int((np.minimum(ctx, window) if window > 0 else ctx).sum())
    return (2.0 * tokens * token_params(m) + attention_flops(m, pairs)
            + 2.0 * max(new_tokens, 1) * m["d_model"] * m["vocab_size"])
