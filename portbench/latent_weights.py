"""The weights of a latent-attention (MLA) configuration, made by the
benchmark from ``--seed`` on the device, as ``weights.py`` makes a GQA
one: the same tree, draws and bookkeeping (``_carve``, ``_size``,
``refill``, ``program_tree`` are ``weights.py``'s), with MLA's attention
leaves in place of ``wq``, ``wk``, ``wv``, ``wo``: the direct query
projection ``wq`` (d, H (nope + rope)), ``wkv_a`` (d, r + rope), ``wkv_b``
(r, H (nope + v)) and ``wo`` (H v, d), each N(0, 1/d_in), and the latent's
norm ``kv_norm`` (ones, fp32).  Only a direct query projection is made
(``q_lora_rank`` 0, DeepSeek-V2-Lite).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from portbench import weights
from portbench.weights import _carve, _size, _stacks, program_tree, refill  # noqa: F401

Leaf = weights.Leaf


def _attn_leaves(m: Dict) -> List[Leaf]:
    if m.get("q_lora_rank"):
        raise ValueError("latent_weights makes a direct query projection only (q_lora_rank 0)")
    d, h = m["d_model"], m["num_heads"]
    nope, rope, vd, r = m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"], m["kv_lora_rank"]
    return [(("attn", "wq"), (d, h * (nope + rope)), d ** -0.5),
            (("attn", "wkv_a"), (d, r + rope), d ** -0.5),
            (("attn", "wkv_b"), (r, h * (nope + vd)), r ** -0.5),
            (("attn", "wo"), (h * vd, d), (h * vd) ** -0.5)]


def _block_leaves(m: Dict, kind: str) -> List[Leaf]:
    """``weights._block_leaves`` with the attention's leaves MLA's."""
    rest = [leaf for leaf in weights._block_leaves(m, kind) if leaf[0][0] != "attn"]
    return _attn_leaves(m) + rest


def make(m: Dict, seed: int, device) -> Dict:
    """The weight tree of the MLA configuration ``m`` (a ``model`` dict),
    drawn from ``seed`` on ``device``; ``weights.make``'s layout."""
    device = torch.device(device)
    dtype = torch.bfloat16 if m.get("dtype", "bfloat16") == "bfloat16" else torch.float32
    d, vp = m["d_model"], (m["vocab_size"] + 255) // 256 * 256

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    params: Dict = {"final_norm": ones(d), "embed": {}}
    embed_leaves = [(("embedding",), (vp, d), 0.02), (("lm_head",), (d, vp), 0.02)]
    flat = torch.empty(_size(embed_leaves), dtype=dtype, device=device)
    groups = [(flat, _carve(flat, embed_leaves, params["embed"]))]
    routers = []
    for key, kind, n in _stacks(m):
        params[key] = []
        for _ in range(n):
            block = {"attn_norm": ones(d), "mlp_norm": ones(d),
                     "attn": {"kv_norm": ones(m["kv_lora_rank"])}}
            leaves = _block_leaves(m, kind)
            flat = torch.empty(_size(leaves), dtype=dtype, device=device)
            groups.append((flat, _carve(flat, leaves, block)))
            if kind == "moe":
                routers.append(block["moe"])
            params[key].append(block)
    if routers:
        e = m["num_experts"]
        flat = torch.empty(len(routers) * d * e, dtype=torch.float32, device=device)
        for i, moe in enumerate(routers):
            moe["router"] = flat[i * d * e:(i + 1) * d * e].view(d, e)
        groups.append((flat, [(flat, 0.02)]))
    params["_groups"] = groups
    refill(params, seed)
    return params
