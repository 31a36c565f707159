"""Variable distribution: the learner is a VariableSource; actors poll it
through a VariableClient (Fig 4's proxy-actor pattern — pull, not push).

The source may be the learner object itself, an in-memory program
``Handle`` to it, or a courier ``RemoteHandle`` when the actor lives in
another process — the client only ever calls ``get_variables`` and cannot
tell the difference.  ``serve_variable_source`` is the one-liner that
exports any ``VariableSource`` over courier RPC.  What crosses courier is
numpy: learners hand out their params as numpy trees.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.interfaces import VariableSource


def _to_numpy(tree):
    """Every tensor in a tree of dicts, lists and tuples as a numpy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return np.asarray(tree)


class VariableClient:
    def __init__(self, source, names: Sequence[str] = ("policy",),
                 update_period: int = 1):
        self._source = source
        self._names = tuple(names)
        self._period = max(int(update_period), 1)
        self._calls = 0
        self._params: Optional[List[Any]] = None
        self._fresh = False

    @property
    def params(self):
        if self._params is None:
            self.update_and_wait()
            # the fetch just happened — the next update() call is satisfied
            # already and must not hit the source a second time.
            self._fresh = True
        return self._params[0] if len(self._names) == 1 else self._params

    def update(self, wait: bool = False):
        """Poll the source every `update_period` calls (synchronous: over a
        remote handle the call is a real RPC, so the period is what bounds
        actor-side traffic)."""
        self._calls += 1
        if wait:
            self.update_and_wait()
            return
        if self._fresh:
            # params were just populated by the property accessor on this
            # very step; skip the redundant initial re-fetch.
            self._fresh = False
            return
        if self._params is None or self._calls % self._period == 0:
            self.update_and_wait()

    def update_and_wait(self):
        self._params = self._source.get_variables(self._names)
        self._fresh = False

    # -- exact resume ----------------------------------------------------
    def state_dict(self) -> dict:
        # Two things must survive: the fetch cadence (_calls % _period
        # decides WHEN weights refresh) and the cached params themselves —
        # with update_period > 1 the cache is legitimately STALER than the
        # learner at checkpoint time, and refetching on resume would hand
        # the actor fresher weights than the uninterrupted run used.
        params = None if self._params is None else _to_numpy(self._params)
        return {"calls": self._calls, "params": params,
                "fresh": self._fresh}

    def load_state_dict(self, state: dict):
        self._calls = int(state["calls"])
        self._params = state.get("params")
        self._fresh = bool(state.get("fresh", False))


class VariableServer(VariableSource):
    """Thread-safe holder used by learners to publish weights.

    ``get_variables`` with empty/omitted ``names`` returns ALL published
    variables (insertion order) — consistent with ``VariableClient``'s
    named-subset requests, which always pass explicit names.
    """

    def __init__(self, **named_vars):
        self._lock = threading.Lock()
        self._vars = dict(named_vars)

    def publish(self, name: str, value):
        with self._lock:
            self._vars[name] = value

    def get_variables(self, names: Sequence[str] = ()):
        with self._lock:
            if not names:
                names = list(self._vars)
            return [self._vars[n] for n in names]


def serve_variable_source(source: VariableSource, name: str = "variables"):
    """Export ``source`` over a courier server; returns ``(server, handle)``.

    The handle is a picklable RPC stub restricted to ``get_variables`` —
    hand it to actors in other processes as their ``VariableClient`` source.
    """
    from repro_torch.distributed.courier import serve
    return serve(source, interface=("get_variables",), name=name)
