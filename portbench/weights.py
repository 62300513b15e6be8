"""The model's weights, made by the benchmark from ``--seed`` on the device.

The program and the plain reference are handed the same tensors; neither
makes its own.  The tree has the layout ``repro_torch``'s ``DecoderLM``
takes (``embed``, ``final_norm``, ``dense_layers``, ``layers``) and the
reference's distributions: embedding and head N(0, 0.02), router N(0,
0.02) in fp32, every projection N(0, 1/d_in), norms 1, in the type the
configuration serves (bf16).  The numbers come from a few large calls on a
``torch.Generator`` on the device: one draw a layer (and one for the
embedding and the head), carved into views, each scaled in place; one
fp32 draw for every router.  ``refill`` draws a new seed into the same
tensors, so a captured program keeps them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

ALIGN = 64   # elements between views' starts, so every view's base is 128-byte aligned

Leaf = Tuple[Tuple, Tuple[int, ...], float]   # (path in the tree, shape, std)


def _block_leaves(m: Dict, kind: str) -> List[Leaf]:
    d, h, kv = m["d_model"], m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or d // h
    leaves = [(("attn", "wq"), (d, h * hd), d ** -0.5),
              (("attn", "wk"), (d, kv * hd), d ** -0.5),
              (("attn", "wv"), (d, kv * hd), d ** -0.5),
              (("attn", "wo"), (h * hd, d), (h * hd) ** -0.5)]
    if kind == "mlp":
        ff = m["d_ff"]
        return leaves + [(("mlp", "w_gate"), (d, ff), d ** -0.5),
                         (("mlp", "w_up"), (d, ff), d ** -0.5),
                         (("mlp", "w_down"), (ff, d), ff ** -0.5)]
    e, ff = m["num_experts"], m["moe_d_ff"]
    leaves += [(("moe", "w_gate"), (e, d, ff), d ** -0.5), (("moe", "w_up"), (e, d, ff), d ** -0.5),
               (("moe", "w_down"), (e, ff, d), ff ** -0.5)]
    sff = ff * m.get("num_shared_experts", 0)
    if sff:
        leaves += [(("moe", "shared", "w_gate"), (d, sff), d ** -0.5),
                   (("moe", "shared", "w_up"), (d, sff), d ** -0.5),
                   (("moe", "shared", "w_down"), (sff, d), sff ** -0.5)]
    return leaves


def _stacks(m: Dict) -> List[Tuple[str, str, int]]:
    nd = m.get("first_dense_layers", 0)
    kind = "moe" if m.get("num_experts") else "mlp"
    return ([("dense_layers", "mlp", nd)] if nd else []) + [("layers", kind, m["num_layers"] - nd)]


def _put(tree: Dict, path: Tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _carve(flat: torch.Tensor, leaves: List[Leaf], tree: Dict) -> List[Tuple[torch.Tensor, float]]:
    out, at = [], 0
    for path, shape, std in leaves:
        n = 1
        for s in shape:
            n *= s
        view = flat[at:at + n].view(shape)
        _put(tree, path, view)
        out.append((view, std))
        at += (n + ALIGN - 1) // ALIGN * ALIGN
    return out


def _size(leaves: List[Leaf]) -> int:
    total = 0
    for _, shape, _ in leaves:
        n = 1
        for s in shape:
            n *= s
        total += (n + ALIGN - 1) // ALIGN * ALIGN
    return total


def make(m: Dict, seed: int, device) -> Dict:
    """The weight tree of the configuration ``m`` (a ``model`` dict), drawn
    from ``seed`` on ``device``."""
    device = torch.device(device)
    dtype = torch.bfloat16 if m.get("dtype", "bfloat16") == "bfloat16" else torch.float32
    d, vp = m["d_model"], (m["vocab_size"] + 255) // 256 * 256
    params: Dict = {"final_norm": torch.ones(d, dtype=torch.float32, device=device)}
    groups = []   # (flat buffer, [(view, std)])
    embed_leaves = [(("embedding",), (vp, d), 0.02), (("lm_head",), (d, vp), 0.02)]
    flat = torch.empty(_size(embed_leaves), dtype=dtype, device=device)
    params["embed"] = {}
    groups.append((flat, _carve(flat, embed_leaves, params["embed"])))
    routers = []
    for key, kind, n in _stacks(m):
        params[key] = []
        for _ in range(n):
            block = {"attn_norm": torch.ones(d, dtype=torch.float32, device=device),
                     "mlp_norm": torch.ones(d, dtype=torch.float32, device=device)}
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


def refill(params: Dict, seed: int) -> None:
    """Draw ``seed``'s numbers into the tree made by ``make``, in place."""
    groups = params["_groups"]
    gen = torch.Generator(device=groups[0][0].device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for flat, views in groups:
            flat.normal_(generator=gen)
            for view, std in views:
                view.mul_(std)


def program_tree(params: Dict) -> Dict:
    """The tree without the benchmark's own bookkeeping, as the program
    takes it."""
    return {k: v for k, v in params.items() if k != "_groups"}
