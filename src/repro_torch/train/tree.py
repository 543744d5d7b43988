"""The port's parameter, gradient and optimizer trees: nested dicts and
tuples with tensor leaves, the reference's pytrees without JAX.

JAX flattens a dict in the order of its sorted keys, while a Python dict
keeps its insertion order. Where the order of the leaves shows in a result
(a float32 sum over leaves, a checkpoint's leaf files) the port takes JAX's
(``jax_leaves``), with the key strings ``jax.tree_util.keystr`` gives a
leaf's path (``['params']['periods'][0]['attn']['wq']``).
"""
from __future__ import annotations

from typing import Callable, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree) -> list:
    """Leaves in the tree's own order (dict insertion order)."""
    out: list = []
    tree_map(out.append, tree)
    return out


def unflatten(tree, new_leaves) -> object:
    """A tree of ``tree``'s structure holding ``new_leaves`` (in
    ``leaves``' order)."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree)


def jax_leaves(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(key string, leaf) in JAX's flatten order: dict keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in jax_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in jax_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def map_with_keys(fn: Callable, tree, prefix: str = ""):
    """``fn(key string, leaf)`` over the leaves, the keys ``jax_leaves``'."""
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(map_with_keys(fn, v, f"{prefix}[{i}]")
                     for i, v in enumerate(tree))
    return fn(prefix, tree)
