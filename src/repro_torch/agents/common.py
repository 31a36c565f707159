"""Shared learner scaffolding for all agents."""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.interfaces import Learner
from repro_torch.optim.optimizers import AdamState
from repro_torch.telemetry import registry as _telemetry


class LearnerState(NamedTuple):
    params: Any
    target_params: Any
    opt_state: Any
    steps: torch.Tensor
    extra: Any = ()


class TorchLearner(Learner):
    """Generic learner: pulls batches from an iterator, applies an SGD step
    on its device, publishes weights, accumulates learner walltime (§4.2 —
    persists through checkpoints).

    ``update_fn(state, sample) -> (state, metrics, priorities)`` gets the
    replay sample with every array moved to ``device`` as a tensor; metrics
    are 0-d tensors and priorities a (batch,) tensor or None.  A step moves
    all metrics, the step counter and the priorities to the host in ONE
    copy, which also waits for the device, and that copy is the step's only
    sync: on a card the batch goes up from pinned memory without waiting.
    The walltime of a step runs from the batch's transfer to the device up
    to the end of that copy.  Its
    host time also goes to the ``learner/step_ms`` histogram (a null metric,
    clock unread, while telemetry is off).
    """

    def __init__(self, state: LearnerState, update_fn, iterator: Iterator,
                 priority_update_cb: Optional[Callable] = None,
                 device="cuda"):
        self._state = state
        self._update = update_fn
        self._iterator = iterator
        self._priority_cb = priority_update_cb
        self._device = torch.device(device)
        self._walltime = 0.0
        self._metrics: Dict[str, float] = {}
        self._m_step_ms = _telemetry.histogram("learner/step_ms")

    @property
    def state(self) -> LearnerState:
        return self._state

    @state.setter
    def state(self, s: LearnerState):
        self._state = s

    @property
    def learner_walltime(self) -> float:
        return self._walltime

    @property
    def metrics(self) -> Dict[str, float]:
        """The metrics of the last step, on the host."""
        return dict(self._metrics)

    def step(self) -> Dict[str, float]:
        sample = next(self._iterator)
        t0 = time.monotonic()
        on_device = tree.map(self._to_device, sample)
        self._state, metrics, priorities = self._update(self._state,
                                                        on_device)
        names = sorted(metrics)
        # ONE host transfer for all metrics, the step counter and the
        # priorities (float64 keeps integer counters exact).
        parts = [torch.stack([metrics[k].double() for k in names]
                             + [self._state.steps.double()])]
        if priorities is not None:
            parts.append(priorities.double().reshape(-1))
        host = torch.cat(parts).cpu().numpy()
        seconds = time.monotonic() - t0
        self._walltime += seconds
        if self._m_step_ms:
            self._m_step_ms.observe(seconds * 1000.0)
        if self._priority_cb is not None and priorities is not None:
            self._priority_cb(np.asarray(sample.info.keys),
                              host[len(names) + 1:])
        self._metrics = {k: float(v) for k, v in zip(names, host)}
        self._metrics["learner_steps"] = float(host[len(names)])
        self._metrics["learner_walltime"] = self._walltime
        return self._metrics

    def _to_device(self, x) -> torch.Tensor:
        if self._device.type != "cuda":
            return torch.as_tensor(x, device=self._device)
        # a copy from pageable memory would wait for the device; one from
        # pinned memory is queued on the stream like any kernel
        return torch.as_tensor(x).pin_memory().to(self._device,
                                                  non_blocking=True)

    def get_variables(self, names: Sequence[str] = ("policy",)):
        return [tree.map(lambda x: x.detach().to("cpu", copy=True).numpy(),
                         self._state.params)
                for _ in (names or ("policy",))]


def fresh_copy(params):
    """Copy a tree's tensors (so params and target params never share
    storage)."""
    return tree.map(torch.clone, params)


def state_from_jax(state, device="cuda") -> LearnerState:
    """The reference learner's ``LearnerState`` (numpy or JAX leaves) as
    the port's: params and target params keep their trees (``()`` where the
    agent has no target), each leaf a tensor on ``device``; Adam's state,
    alone or in a tuple of states (the continuous learners carry one for the
    policy and one for the critic), as the port's ``AdamState``."""
    def tensors(x):
        return tree.map(lambda a: torch.tensor(np.asarray(a), device=device),
                        x)

    def opt(x):
        if hasattr(x, "_fields"):                    # an AdamState
            return AdamState(*(tensors(field) for field in x))
        return tuple(opt(s) for s in x)

    return LearnerState(tensors(state.params), tensors(state.target_params),
                        opt(state.opt_state), tensors(state.steps))


def importance_weights(probs: torch.Tensor, beta: float = 0.6) -> torch.Tensor:
    """PER importance-sampling weights, max-normalized (Schaul et al. 2015)."""
    w = (1.0 / torch.clamp(probs.float(), min=1e-12)) ** beta
    return w / torch.max(w)
