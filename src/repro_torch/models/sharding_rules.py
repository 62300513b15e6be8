"""Partition-spec rules for parameters, optimizer state and caches.

Counterpart of ``repro.models.sharding_rules``, rule for rule.  Rules are
name-based (the layer library's naming convention, the leaf names
``checkpoint.convert`` maps to the reference's) and rank-relative: a leaf
with more dims than its rule gets ``None`` prepended.  The reference
stacks each per-layer parameter on a leading layer axis; the port keeps a
list of per-layer dicts, so the same rule gives a per-layer leaf the
reference's spec without its leading ``None``.

Weight sharding follows the Megatron mapping onto the ``model`` axis --
column-parallel up-projections, row-parallel down-projections,
vocab-sharded embedding, expert-parallel MoE stacks -- the 1-D torus
solution family of the paper's equations (``repro_torch.dist.ring``).

A spec is the port's tuple (``plan.lower_dist.P``) and a sharding a
``runtime.sharding.NamedSharding``; trees are the port's nested dicts and
lists (``repro_torch.tree``), their leaves anything with a ``shape``
(tensors, fake tensors, ``runtime.sharding.Placed``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from repro_torch.plan.lower_dist import P
from repro_torch.runtime.sharding import (MODEL_AXIS, NamedSharding, planned_matmul_axes,
                                          resolve_axis)
from repro_torch.tree import tree_map

# name -> (base_rank, base_spec over logical axes)
_RULES: Dict[str, Tuple[int, Tuple]] = {
    # embeddings
    "embedding": (2, ("model", None)),
    "lm_head": (2, (None, "model")),
    # attention / generic projections (column-parallel)
    "wq": (2, (None, "model")),
    "wk": (2, (None, "model")),
    "wv": (2, (None, "model")),
    "wq_a": (2, (None, "model")),
    "wq_b": (2, (None, "model")),
    "wkv_a": (2, (None, "model")),
    "wkv_b": (2, (None, "model")),
    "w_in": (2, (None, "model")),
    "w_gates": (2, (None, "model")),
    "in_proj": (2, (None, "model")),
    "shared_in": (2, (None, "model")),
    # row-parallel
    "wo": (2, ("model", None)),
    "w_down": (2, ("model", None)),
    "out_proj": (2, ("model", None)),
    # dense mlp column-parallel
    "w_gate": (2, (None, "model")),
    "w_up": (2, (None, "model")),
    # moe expert stacks (expert-parallel) -- matched with parent 'moe'
    "moe/w_gate": (3, ("model", None, None)),
    "moe/w_up": (3, ("model", None, None)),
    "moe/w_down": (3, ("model", None, None)),
    "router": (2, (None, None)),
}


def _path_names(path) -> Tuple[str, ...]:
    """A port tree path (dict keys and list indices) as strings, as the
    reference names a JAX key path."""
    return tuple(str(e) for e in path)


def _map_with_path(fn: Callable, tree: Any, prefix: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of a port tree, its structure kept."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _spec_for(path, leaf) -> tuple:
    names = _path_names(path)
    name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    # expert stacks sit directly under "moe"; the shared expert is a plain
    # MLP nested at moe/shared/* and must use the dense rules
    key = f"moe/{name}" if parent == "moe" and f"moe/{name}" in _RULES else name
    if key not in _RULES:
        return P()  # replicated (norms, biases, A_log, conv, r, ...)
    base_rank, base = _RULES[key]
    extra = len(_shape(leaf)) - base_rank
    if extra < 0:
        return P()
    return P(*((None,) * extra + base))


def param_specs(params: Any) -> Any:
    """Tree of specs mirroring ``params``."""
    return _map_with_path(_spec_for, params)


# weights below this size are cheaper replicated than collectived over
_AUTO_MIN_DIM = 128


def ranked_linear_spec(shape, mesh, *, tokens: int = 8192) -> tuple:
    """Estimate-ranked spec for a 2-D weight not covered by ``_RULES``:
    prices column- vs row-parallel with the plan cost model
    (``runtime.sharding.planned_matmul_axes``) instead of assuming a name
    convention.  Replicated for weights too small to be worth a collective
    or not divisible by the model axis."""
    if len(shape) != 2 or min(shape) < _AUTO_MIN_DIM:
        return P()
    model = mesh.shape.get(MODEL_AXIS, 1)
    if model <= 1:
        return P()
    axes = planned_matmul_axes(shape[0], shape[1], mesh=mesh, tokens=tokens)
    axes = tuple(
        a if a is not None and shape[i] % model == 0 else None
        for i, a in enumerate(axes)
    )
    return P(*axes)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= _axis_size(mesh, a)
        return out
    return mesh.shape.get(axis, 1)


def param_shardings(params: Any, mesh, *, auto_matmul: bool = False) -> Any:
    """Resolve logical specs against ``mesh``, dropping any sharded axis a
    dimension cannot honour (e.g. tiny gate projections vs model=16).

    ``auto_matmul=True`` additionally consults the plan cost model for 2-D
    weights the name table leaves replicated (``ranked_linear_spec``)."""

    drop = _resolve_dropping(mesh)

    def resolve(leaf, spec: tuple) -> NamedSharding:
        if auto_matmul and tuple(spec) == () and len(_shape(leaf)) == 2:
            spec = ranked_linear_spec(_shape(leaf), mesh)
        return drop(leaf, spec)

    return tree_map(resolve, params, param_specs(params))


# decode-cache layout.  The reference's cache tensors are (L, B, ...) and
# the dims below count that leading layer axis; the port's are one layer's
# (B, ...) in a per-layer list, so ``cache_specs`` reads each dim one lower
# there.  Per name the candidate dims to shard over 'model', in priority
# order (first divisible dimension wins).  KV caches prefer heads, then the
# SEQUENCE axis: seq-sharding is split-KV (flash-decoding) -- the paper's
# contraction-axis parallelism applied to decode.
_CACHE_MODEL_DIMS = {
    "k": (3, 2),        # (L, B, S, H_kv, Dh): heads, else seq (split-KV)
    "v": (3, 2),
    "c_kv": (2,),       # (L, B, S, R): seq (split-KV in the latent space)
    "k_rope": (2,),
    "ssm": (2,),        # (L, B, H, P, N): heads
    "conv": (3,),       # (L, B, K, C): channels
    "C": (2, 3),        # mLSTM state (L, B, H, D, D)
    "n": (2,),
    "h": (2,),
    "c": (2,),
}
_CACHE_SEQ_DIM = {"k": 2, "v": 2, "c_kv": 2, "k_rope": 2}


def cache_specs(cache: Any, *, shard_batch: bool,
                model_size: int = 1, data_size: int = 1) -> Any:
    """Decode-cache specs.

    shard_batch=True: batch over ('pod','data') AND the first divisible
    head/feature dim over 'model'.  shard_batch=False (batch 1): the KV
    sequence over 'data' (split-KV decode) plus the same model-axis dim."""

    def spec(path, leaf) -> tuple:
        names = _path_names(path)
        name = names[-1]
        shape = _shape(leaf)
        n = len(shape)
        # one layer's tensor (in a per-layer list) lacks the reference's
        # leading layer axis
        lead = 1 if any(isinstance(e, int) for e in path) else 0
        axes = [None] * n
        if shard_batch:
            b = 1 - lead
            if n >= b + 1 and shape[b] % max(data_size, 1) == 0:
                axes[b] = "batch"
        else:
            sd = _CACHE_SEQ_DIM.get(name)
            if sd is not None:
                sd -= lead
            if sd is not None and sd < n and shape[sd] % max(data_size, 1) == 0:
                axes[sd] = "data"
        for dim in _CACHE_MODEL_DIMS.get(name, ()):
            dim -= lead
            if dim < n and axes[dim] is None and model_size > 1 \
                    and shape[dim] % model_size == 0:
                axes[dim] = "model"
                break
        return P(*axes)

    return _map_with_path(spec, cache)


def _resolve_dropping(mesh):
    def resolve(leaf, spec: tuple) -> NamedSharding:
        axes = [resolve_axis(a, mesh) for a in spec]
        shape = _shape(leaf)
        for i, a in enumerate(axes):
            if a is None or i >= len(shape):
                continue
            if shape[i] % _axis_size(mesh, a) != 0:
                axes[i] = None
        return NamedSharding(mesh, P(*axes))
    return resolve


def cache_shardings(cache: Any, mesh, *, shard_batch: bool) -> Any:
    model_size = mesh.shape.get("model", 1)
    data_size = _axis_size(mesh, resolve_axis("batch", mesh))
    specs = cache_specs(
        cache, shard_batch=shard_batch,
        model_size=model_size,
        data_size=data_size if shard_batch else mesh.shape.get("data", 1),
    )
    return tree_map(_resolve_dropping(mesh), cache, specs)


def zero_shardings(params: Any, mesh) -> Any:
    """ZeRO-1 shardings for fp32 optimizer state (master/m/v): the param
    spec plus the data axes on the largest still-unsharded dimension
    (a per-layer leaf's own dims: the port has no layer axis to pick)."""
    data_axes = resolve_axis("batch", mesh)  # ('pod','data') when multi-pod
    dsize = _axis_size(mesh, data_axes)

    def resolve(leaf, spec: tuple) -> NamedSharding:
        shape = _shape(leaf)
        axes = [resolve_axis(a, mesh) for a in spec]
        axes += [None] * (len(shape) - len(axes))  # replicated-spec padding
        for i, a in enumerate(axes):
            if a is not None and i < len(shape) \
                    and shape[i] % _axis_size(mesh, a) != 0:
                axes[i] = None
        if dsize > 1 and len(shape) >= 1:
            cands = [i for i in range(len(shape))
                     if axes[i] is None and shape[i] % dsize == 0]
            if cands:
                best = max(cands, key=lambda i: shape[i])
                axes[best] = data_axes
        return NamedSharding(mesh, P(*axes[: len(shape)]))

    return tree_map(resolve, params, param_specs(params))
