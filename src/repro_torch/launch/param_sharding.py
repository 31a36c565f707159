"""Name-based logical axes for every parameter leaf in the model zoo.

``param_logical_axes(path, shape)`` returns a tuple of logical axis names
(resolved to mesh axes by :class:`repro_torch.sharding.ShardingRules`, which
also handles divisibility fallbacks — e.g. 4 KV heads on a 16-way model axis
degrade to replication rather than failing to shard).

Paths are ``repro_torch.tree.flatten_with_path``'s.  The port keeps a
stack's layers as a list of per-layer dicts, so a leaf has no leading
layer axis and resolves to the JAX package's spec of the stacked leaf
without its leading ``layers`` entries (the rules replicate ``layers``).
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch import tree as tree_lib
from repro_torch.tree import DictKey, GetAttrKey


def _key_names(path) -> Tuple[str, ...]:
    names = []
    for p in path:
        if isinstance(p, DictKey):
            names.append(str(p.key))
        elif isinstance(p, GetAttrKey):
            names.append(p.name)
    return tuple(names)


def param_logical_axes(path, shape) -> Tuple[Optional[str], ...]:
    names = _key_names(path)
    leaf = names[-1] if names else ""
    parents = set(names[:-1])
    nd = len(shape)

    def pad(axes):
        """Left-pad with stacked-layer axes (scan stacking adds 1-2 dims)."""
        extra = nd - len(axes)
        return tuple(["layers"] * extra) + tuple(axes)

    if leaf == "table":                      # embed / lm_head: (V, d)
        # if vocab doesn't divide the model axis (92553, 51865, ...) the
        # embed_d rule shards d_model instead (axis-dedup keeps it legal).
        return ("vocab", "embed_d")
    if leaf in ("scale", "A_log", "dt_bias", "D", "conv_b", "q_norm", "k_norm"):
        return pad([None] * 1) if nd >= 1 else ()
    if leaf == "wq":
        return pad(("d_model", "heads", "head_dim"))
    if leaf in ("wk", "wv"):
        return pad(("d_model", "kv_heads", "head_dim"))
    if leaf == "wo":
        return pad(("heads", "head_dim", "d_model"))
    if leaf in ("w_gate", "w_up"):
        if "experts" in parents:             # (E, d, f)
            return pad(("experts", "d_model", "expert_ff"))
        return pad(("d_model", "ff"))
    if leaf == "w_down":
        if "experts" in parents:             # (E, f, d)
            return pad(("experts", "expert_ff", "d_model"))
        return pad(("ff", "d_model"))
    if leaf == "router":                     # (d, E) — replicated (tiny)
        return pad(("d_model", None))
    if leaf == "in_proj":                    # (d, packed) — packed dim on model
        return pad(("d_model", "ff"))
    if leaf == "out_proj":                   # (d_inner, d)
        return pad(("ff", "d_model"))
    if leaf == "conv_w":                     # (w, channels)
        return pad((None, "ff"))
    return tuple([None] * nd)


def tree_logical_axes(tree):
    return tree_lib.map_with_path(
        lambda path, x: param_logical_axes(path, x.shape), tree)


def tree_pspecs(tree, rules):
    """PartitionSpec tree for a param(-like) tree under ``rules``."""
    return tree_lib.map_with_path(
        lambda path, x: rules.mesh_axes(param_logical_axes(path, x.shape),
                                        tuple(x.shape)),
        tree)


def tree_shardings(tree, rules, zero: bool = False):
    """DTensor placements for every leaf, one a mesh dimension.
    ``zero=True`` additionally shards each leaf's first free divisible dim
    over the data(+pod) axes — ZeRO-1 optimizer-state partitioning."""

    def one(path, x):
        shape = tuple(x.shape)
        spec = rules.mesh_axes(param_logical_axes(path, shape), shape)
        if zero and len(shape):
            spec = rules.zero_spec(spec, shape)
        return rules.placements(spec)

    return tree_lib.map_with_path(one, tree)
