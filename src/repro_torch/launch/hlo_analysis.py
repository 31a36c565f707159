"""Roofline terms of one rank's local program on a torch mesh.

The JAX package's ``hlo_analysis`` parses the compiled (post-SPMD) HLO text
of a step.  The port produces no HLO: its dry run runs a step eagerly on
``DTensor``s over fake tensors, so it has no counterpart of that parser.
:class:`LocalCounter` fills the same :class:`Analysis` from that run, op by
op, at the level of one rank's local tensors:

  * ``flops`` / ``dot_flops`` / ``conv_flops`` — ``torch.utils.flop_counter``'s
    formulas (2*M*N*K for a product) on the LOCAL shapes;
  * ``hbm_bytes``        — operand plus output bytes of every op that
                           returns a tensor and is not a view: an eager
                           model with no fusion, so it is larger than a
                           fused program's traffic;
  * ``collective_bytes`` — operand bytes of the c10d functional collectives
                           DTensor issues, by the HLO's five kinds;

and, besides, the peak of the bytes of live local storages (``peak_bytes``).
All quantities are **per rank**, as the HLO of one SPMD device.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import threading
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


@dataclass
class Analysis:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(
        default_factory=lambda: defaultdict(lambda: {"count": 0.0, "bytes": 0.0}))
    dot_flops: float = 0.0
    conv_flops: float = 0.0

    def as_dict(self):
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
        }


# c10d functional collectives (what DTensor's redistributions issue) by the
# HLO collective kind they stand for
_C10D_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "isend": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}
_CONV_OPS = ("convolution", "_convolution", "convolution_backward",
             "convolution_overrideable", "cudnn_convolution",
             "_slow_conv2d_forward")


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """An op whose every output aliases an input without writing it."""
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


_PAUSE = threading.local()


def _paused() -> bool:
    return getattr(_PAUSE, "depth", 0) > 0


@contextlib.contextmanager
def _pause():
    """Ops inside are no part of the rank's program: not counted."""
    _PAUSE.depth = getattr(_PAUSE, "depth", 0) + 1
    try:
        yield
    finally:
        _PAUSE.depth -= 1


def _wrap(stack, module_name, owner_name, name, wrapper):
    """Replace ``module.owner.name`` (``owner_name`` None: ``module.name``)
    by ``wrapper(original)`` until ``stack`` closes, which puts the
    original back.  A torch without that private name is left as it is."""
    import importlib
    try:
        owner = importlib.import_module(module_name)
        if owner_name:
            owner = getattr(owner, owner_name)
        raw = inspect.getattr_static(owner, name)
        original = getattr(owner, name)
    except (ImportError, AttributeError):
        return
    setattr(owner, name, functools.wraps(original)(wrapper(original)))
    stack.callback(setattr, owner, name, raw)


@contextlib.contextmanager
def _dtensor_patched():
    """Adjust three private parts of DTensor for the count while the block
    runs, and put them back after it (a torch that lacks one is left as it
    is):

    * DTensor derives an op's output shape by running it once more on fake
      tensors of the GLOBAL shapes (``_propagate_tensor_meta_non_cached``):
      no part of a rank's program, so not counted;
    * a ``_StridedShard`` (two sharded dims merged by a view) computes its
      local size from ``torch.arange(n).tolist()``, which under an active
      ``FakeTensorMode`` is a fake tensor without values and raises; it
      runs with the fake mode unset, on a small real tensor, uncounted;
    * the lookup of a foreach op's one-tensor op walks every overload's
      schema at each call (0.1 s; Adam makes hundreds): it is cached.
    """
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def paused(original):
        def run(*args, **kwargs):
            with _pause():
                return original(*args, **kwargs)
        return run

    def real_and_paused(original):
        def run(*args, **kwargs):
            with _pause(), unset_fake_temporarily():
                return original(*args, **kwargs)
        return run

    cached = {}

    def memo(original):
        def run(op):
            if op not in cached:
                cached[op] = original(op)
            return cached[op]
        return run

    with contextlib.ExitStack() as stack:
        _wrap(stack, "torch.distributed.tensor._sharding_prop",
              "ShardingPropagator", "_propagate_tensor_meta_non_cached",
              paused)
        _wrap(stack, "torch.distributed.tensor.placement_types",
              "_StridedShard", "local_shard_size_and_offset",
              real_and_paused)
        for module in ("single_dim_strategy", "autogen"):
            _wrap(stack, "torch.distributed.tensor._ops." + module, None,
                  "_resolve_foreach_elementwise_overload", memo)
        yield


class LocalCounter(TorchDispatchMode):
    """Counts one rank's local program while it is entered (above a
    ``FakeTensorMode``, so no op allocates or computes).

    An op on ``DTensor``s is handed back to DTensor (``NotImplemented``),
    which desugars it into collectives and a local op on the local
    tensors; both come back here, so every count is per rank, as the
    HLO of one SPMD device.  ``track(tree)`` adds the storages of a
    step's arguments to the live set before the step runs.
    """

    def __init__(self):
        super().__init__()
        self._patches = contextlib.ExitStack()
        self.analysis = Analysis()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops = 0
        self._seen = {}

    def __enter__(self):
        self._patches.enter_context(_dtensor_patched())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patches.close()

    def track(self, tree):
        from torch.distributed.tensor import DTensor
        for t in _tensors(tree):
            self._hold(t._local_tensor if isinstance(t, DTensor) else t)

    def _hold(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key):
        self.live_bytes -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _paused():
            return out
        self.ops += 1
        acc = self.analysis
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            kind = _C10D_KINDS.get(name)
            if kind is not None:
                in_b = sum(_nbytes(t) for t in _tensors((args, kwargs)))
                acc.collective_bytes += in_b
                st = acc.collectives[kind]
                st["count"] += 1
                st["bytes"] += in_b
        elif not _is_view(func) and _tensors(out):
            # an op that returns no tensor (``prim.device``, a size) moves
            # no bytes
            acc.hbm_bytes += sum(_nbytes(t) for t in
                                 _tensors((args, kwargs, out)))
            packet = func._overloadpacket
            if packet in flop_registry:
                f = flop_registry[packet](*args, **kwargs, out_val=out)
                acc.flops += f
                if name in _CONV_OPS:
                    acc.conv_flops += f
                else:
                    acc.dot_flops += f
        for t in _tensors(out):
            self._hold(t)
        return out

