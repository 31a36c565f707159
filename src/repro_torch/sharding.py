"""Logical-axis sharding: rules mapping logical axes -> mesh axes.

Models annotate activations with *logical* axes (``'batch'``, ``'seq'``,
``'heads'``, ...).  A :class:`ShardingRules` context installed by the launcher
resolves those to the dimensions of a torch ``DeviceMesh`` and, on a
``DTensor``, ``redistribute``s to the resolved placements.  Outside any
context, and on a plain tensor, annotations are no-ops, so model code is
mesh-agnostic and no path that runs on plain tensors changes its bits.

torch has no ``PartitionSpec``: :class:`PartitionSpec` here is a tuple of
one entry a tensor dimension (``None``, a mesh axis name, or a tuple of
names), equal as a tuple to the JAX package's spec.  ``named_sharding``
turns one into DTensor placements, one a mesh dimension.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, Optional, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]

# Baseline (paper-faithful + megatron tensor sharding) logical rules.
# 'data' carries the batch; 'model' carries heads / ff / experts / vocab.
BASE_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    # residual-stream activations: Megatron-style sequence parallelism —
    # between blocks activations are sharded along seq on the model axis
    # (XLA inserts the all-gather/reduce-scatter pairs around attention/mlp).
    "act_seq": "model",
    # q_seq: sequence-parallel attention — used when num_heads doesn't divide
    # the model axis (attention would otherwise replicate); shards the query
    # positions instead of heads, with no extra collectives beyond the K/V
    # gather.
    "q_seq": None,
    "seq": None,
    "kv_seq": None,
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    # experts first (expert parallelism when E divides the axis); otherwise
    # axis-dedup falls through to tensor-parallel expert ffn (expert_ff).
    "experts": "model",
    "expert_ff": "model",
    # MoE token groups follow the batch axes only: the expert-ffn einsum
    # needs g off the model axis (expert_ff lives there), and g-resharding
    # finer->coarser trips the partitioner's replicate-then-repartition
    # fallback (88GB buffers).  Keeping g@(pod,data) end-to-end avoids it.
    "moe_groups": ("pod", "data"),
    "vocab": "model",
    "embed_d": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "layers": None,
    "conv": None,
}


class PartitionSpec(tuple):
    """One entry a tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (the dimension split over all of them).
    A tuple, so it compares equal to the JAX package's ``PartitionSpec``
    of the same entries as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _mesh_axes_and_sizes(mesh):
    """(axis names, sizes) of a torch ``DeviceMesh`` (``mesh_dim_names``,
    ``mesh.shape``) or of a duck-typed mesh with ``axis_names`` and
    ``devices.shape``, as the JAX package's rules read one."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), tuple(mesh.shape)
    return tuple(mesh.axis_names), tuple(mesh.devices.shape)


class ShardingRules:
    def __init__(self, mesh, rules: Optional[Dict[str, MeshAxes]] = None):
        self.mesh = mesh
        self.rules = dict(BASE_RULES)
        if rules:
            self.rules.update(rules)
        names, sizes = _mesh_axes_and_sizes(mesh)
        self._axis_names = names
        self._axis_sizes = dict(zip(names, sizes))

    def mesh_axes(self, logical: Tuple[Optional[str], ...], dims=None) -> P:
        """Resolve logical axes to a PartitionSpec, dropping mesh axes that
        don't exist on this mesh, don't divide the dimension, or were already
        consumed by an earlier dim (a mesh axis may appear only once)."""
        out = []
        used = set()
        for i, name in enumerate(logical):
            axes = self.rules.get(name) if name else None
            if axes is None:
                out.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            axes = tuple(a for a in axes if a in self._axis_sizes and a not in used)
            if not axes:
                out.append(None)
                continue
            if dims is not None:
                kept = []
                prod = 1
                for a in axes:
                    if dims[i] % (prod * self._axis_sizes[a]) == 0:
                        kept.append(a)
                        prod *= self._axis_sizes[a]
                axes = tuple(kept)
                if not axes:
                    out.append(None)
                    continue
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
        return P(*out)

    def zero_spec(self, spec: P, dims) -> P:
        """ZeRO-style: additionally shard the first free, divisible dim over
        the data(+pod) axes — used for optimizer states (ZeRO-1)."""
        used = set()
        for entry in spec:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                used.add(a)
        candidates = [a for a in ("data", "pod") if a in self._axis_sizes
                      and a not in used]
        if not candidates:
            return spec
        out = list(spec) + [None] * (len(dims) - len(spec))
        for i, d in enumerate(dims):
            if out[i] is not None:
                continue
            kept = []
            prod = 1
            for a in candidates:
                if d % (prod * self._axis_sizes[a]) == 0:
                    kept.append(a)
                    prod *= self._axis_sizes[a]
            if kept:
                out[i] = tuple(kept) if len(kept) > 1 else kept[0]
                break
        return P(*out)

    def placements(self, spec: P) -> tuple:
        """DTensor placements for ``spec``, one a mesh dimension:
        ``Shard(i)`` on every mesh axis that tensor dim ``i`` names,
        ``Replicate()`` on the rest and on an axis of size 1 (one rank
        holds the whole dim either way).

        DTensor splits a tensor dim that several mesh axes shard in mesh
        order (the first mesh dimension outermost), whatever the order of
        the names in the spec.  So ``("pod", "data")``, which is mesh
        order, places each shard where the JAX package does, and
        ``zero_spec``'s ``("data", "pod")`` gives the same local shapes
        there, with the slices held by other ranks: rank (pod p, data d)
        holds slice ``p * data + d``, not ``d * pod + p``."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate() for _ in self._axis_names]
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if self._axis_sizes[axis] > 1:
                    out[self._axis_names.index(axis)] = Shard(dim)
        return tuple(out)

    def named_sharding(self, logical, dims=None) -> tuple:
        """The placements of ``mesh_axes(logical, dims)`` on this mesh."""
        return self.placements(self.mesh_axes(logical, dims))


_tls = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


def _is_dtensor(x) -> bool:
    # no DTensor exists before its module is loaded, so a run on plain
    # tensors never pays for the import (a second or so)
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(x, module.DTensor)


def distributed(x) -> bool:
    """Whether ``x`` is a ``DTensor`` under a rules context: the layout
    hints act on it."""
    return current_rules() is not None and _is_dtensor(x)


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``placements``, and its gradient to the same
    placements, as JAX transposes a sharding constraint into the same
    constraint on the cotangent (DTensor's own ``redistribute`` sends the
    gradient back to ``x``'s placements instead)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad, None


def shard(x, *logical: Optional[str]):
    """Annotate activation ``x`` with logical axes.  A no-op outside a
    context and on a tensor that is not a ``DTensor`` (the JAX package's
    constraint does nothing on a one-device mesh either); a ``DTensor`` is
    redistributed to the resolved placements, its values unchanged, and so
    is its gradient in the backward."""
    r = current_rules()
    if r is None or not _is_dtensor(x):
        return x
    placements = r.named_sharding(tuple(logical), dims=tuple(x.shape))
    if tuple(x.placements) == placements and not x.requires_grad:
        return x
    return _Constrain.apply(x, placements)
