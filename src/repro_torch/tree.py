"""Parameter trees: nested dicts and lists with tensor leaves.

The port's counterpart of the ``jax.tree`` calls the training path makes.
Dict keys are visited in sorted order, as JAX visits them, so a tree's
leaves come out in the same order whatever order its dicts were built in.
A path is the tuple of dict keys and list indices down to a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Tree = Any


def tree_paths(tree: Tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) for every leaf, in the order of ``tree_leaves``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template: Tree, leaves: List[Any]) -> Tree:
    """A tree shaped as ``template`` whose leaves are ``leaves``, taken in
    the order of ``tree_leaves(template)``."""
    index = {path: i for i, (path, _) in enumerate(tree_paths(template))}
    if len(index) != len(leaves):
        raise ValueError(f"template has {len(index)} leaves, got {len(leaves)}")

    def fill(t, prefix):
        if isinstance(t, dict):
            return {k: fill(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v, prefix + (i,)) for i, v in enumerate(t))
        return leaves[index[prefix]]

    return fill(template, ())
