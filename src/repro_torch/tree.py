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

``flatten_with_path`` and ``map_with_path`` give each leaf its path, a
tuple of ``DictKey``, ``GetAttrKey`` (a NamedTuple field) and
``SequenceKey`` (a list or tuple item) entries, the counterparts of
``jax.tree_util``'s key types.

The one module of the port without a counterpart file in the JAX package:
there, ``jax.tree`` does this work.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np

TreeDef = Any      # None for a leaf, else (kind, [child treedefs])


def _kind(node):
    """What an inner node is, comparable between trees as JAX compares
    node types: ``("dict", sorted keys)``, a NamedTuple's class, ``list``,
    ``tuple`` or ``"None"``; None for a leaf."""
    if isinstance(node, dict):
        return ("dict", tuple(sorted(node)))
    if isinstance(node, (list, tuple)):          # NamedTuples too
        return type(node)
    if node is None:
        return "None"
    return None


def _children(node, kind) -> list:
    if kind == "None":
        return []
    if isinstance(kind, tuple):                   # a dict
        return [node[k] for k in kind[1]]
    return list(node)


def _rebuild(kind, children):
    if kind == "None":
        return None
    if isinstance(kind, tuple):
        return dict(zip(kind[1], children))
    if kind in (list, tuple):
        return kind(children)
    return kind(*children)                        # a NamedTuple


# The walks below are module functions that take their accumulator as an
# argument: a nested function that calls itself is a reference cycle
# (function, closure cell, function), and one that closes over the list of
# leaves keeps every leaf alive until the cyclic collector runs, which on
# a large model's update is several param-sized copies on the device.
def _walk(node, leaves: List[Any]):
    kind = _kind(node)
    if kind is None:
        leaves.append(node)
        return None
    return kind, [_walk(child, leaves) for child in _children(node, kind)]


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    """The leaves in JAX order, and the structure to rebuild the tree."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(d, leaves, position: List[int]):
    if d is None:
        position[0] += 1
        return leaves[position[0] - 1]
    kind, kids = d
    return _rebuild(kind, [_build(k, leaves, position) for k in kids])


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` in JAX order."""
    leaves = list(leaves)
    position = [0]
    tree = _build(treedef, leaves, position)
    if position[0] != len(leaves):
        raise ValueError(f"tree has {position[0]} leaves, got {len(leaves)}")
    return tree


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def _name(kind) -> str:
    if isinstance(kind, tuple):
        return f"dict with keys {list(kind[1])}"
    return kind if isinstance(kind, str) else kind.__name__


def _flatten_up_to(treedef: TreeDef, tree) -> List[Any]:
    """``tree``'s subtrees at the leaves of ``treedef``, in JAX order, as
    ``jax.tree.map`` reads each of its later trees: ``tree`` must have the
    structure of ``treedef`` down to its leaves (the same node kinds: dict
    keys, container types, NamedTuple types, ``None`` in the same places),
    and a leaf of ``treedef`` takes the whole subtree found there.  Raises
    ``ValueError`` where the structures differ."""
    out: List[Any] = []
    _walk_up_to(treedef, tree, out)
    return out


def _walk_up_to(d, node, out: List[Any]):
    if d is None:
        out.append(node)
        return
    kind, kids = d
    if _kind(node) != kind:
        raise ValueError(f"tree structures differ: expected "
                         f"{_name(kind)}, got {node!r}")
    children = _children(node, kind)
    if len(children) != len(kids):
        raise ValueError(f"tree structures differ: {_name(kind)} of "
                         f"{len(kids)} children, got {len(children)}")
    for k, child in zip(kids, children):
        _walk_up_to(k, child, out)


def map(fn: Callable, tree, *rest):   # noqa: A001 — mirrors jax.tree.map
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest``, each of which must have ``tree``'s structure (or ``tree`` as
    a prefix), as ``jax.tree.map`` requires: ``ValueError`` otherwise."""
    flat, treedef = flatten(tree)
    others = [_flatten_up_to(treedef, r) for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


class DictKey(NamedTuple):
    key: Any


class GetAttrKey(NamedTuple):
    name: str


class SequenceKey(NamedTuple):
    idx: int


def _path_keys(node, kind) -> list:
    if kind == "None":
        return []
    if isinstance(kind, tuple):                   # a dict
        return [DictKey(k) for k in kind[1]]
    if kind in (list, tuple):
        return [SequenceKey(i) for i in range(len(node))]
    return [GetAttrKey(f) for f in kind._fields]  # a NamedTuple


def _walk_paths(node, path, out: List[Any]):
    kind = _kind(node)
    if kind is None:
        out.append((path, node))
        return
    for key, child in zip(_path_keys(node, kind), _children(node, kind)):
        _walk_paths(child, path + (key,), out)


def flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], TreeDef]:
    """``(path, leaf)`` pairs in JAX order, and the structure to rebuild
    the tree, as ``jax.tree_util.tree_flatten_with_path``."""
    pairs: List[Tuple[tuple, Any]] = []
    _walk_paths(tree, (), pairs)
    return pairs, flatten(tree)[1]


def map_with_path(fn: Callable, tree, *rest):
    """``fn(path, leaf, *others)`` over the leaves of ``tree``, as
    ``jax.tree_util.tree_map_with_path``."""
    pairs, treedef = flatten_with_path(tree)
    others = [_flatten_up_to(treedef, r) for r in rest]
    return unflatten(treedef, [fn(path, x, *xs) for (path, x), *xs
                               in zip(pairs, *others)])


def stack(trees) -> Any:
    """Stack a list of trees of the same structure, leaf by leaf, along a
    new leading axis, as numpy arrays (``ValueError`` where two trees'
    structures differ)."""
    return map(lambda *xs: np.stack([np.asarray(x) for x in xs], axis=0),
               *trees)
