"""Trees of tensors and arrays, walked in JAX's order.

The JAX package keeps params, optimizer state and replay items as pytrees,
and its leaf order decides how they flatten (checkpoint leaf names, optimizer
state layout).  ``torch.utils._pytree`` keeps dict insertion order, so the
port walks trees here instead, as ``jax.tree`` does:

- a dict's children are its values by sorted key, and a dict built by
  ``map`` has its keys in that sorted order;
- a NamedTuple's children are its fields in declared order, and lists and
  tuples their items in order;
- ``None`` is an empty subtree;
- anything else (a tensor, an array, a number) is a leaf.

The one module of the port without a counterpart file in the JAX package:
there, ``jax.tree`` does this work.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np

TreeDef = Any      # None for a leaf, else (rebuild, [child treedefs])


def _children(node):
    """(children, rebuild) of an inner node; None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return [node[k] for k in keys], lambda cs: dict(zip(keys, cs))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node), lambda cs: type(node)(*cs)
    if isinstance(node, (list, tuple)):
        return list(node), lambda cs: type(node)(cs)
    if node is None:
        return [], lambda cs: None
    return None


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    """The leaves in JAX order, and the structure to rebuild the tree."""
    leaves: List[Any] = []

    def walk(node):
        inner = _children(node)
        if inner is None:
            leaves.append(node)
            return None
        children, rebuild = inner
        return rebuild, [walk(child) for child in children]

    return leaves, walk(tree)


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` in JAX order."""
    leaves = list(leaves)
    position = 0

    def build(d):
        nonlocal position
        if d is None:
            position += 1
            return leaves[position - 1]
        rebuild, kids = d
        return rebuild([build(k) for k in kids])

    tree = build(treedef)
    if position != len(leaves):
        raise ValueError(f"tree has {position} leaves, got {len(leaves)}")
    return tree


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def map(fn: Callable, tree, *rest):   # noqa: A001 — mirrors jax.tree.map
    """``fn`` over the leaves of ``tree`` and of ``rest``, which must have
    as many leaves in the same order."""
    flat, treedef = flatten(tree)
    others = [leaves(r) for r in rest]
    for other in others:
        if len(other) != len(flat):
            raise ValueError(f"tree structures differ: {len(flat)} leaves "
                             f"vs {len(other)}")
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def stack(trees) -> Any:
    """Stack a list of trees of the same structure, leaf by leaf, along a
    new leading axis, as numpy arrays."""
    return map(lambda *xs: np.stack([np.asarray(x) for x in xs], axis=0),
               *trees)
