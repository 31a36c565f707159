"""Generic actors (§2.3): feed-forward, and its batched form.

A ``FeedForwardActor`` evaluates a policy function and forwards its
observations to an adder.  It pulls weights from a ``VariableClient`` on
``update()`` — it never owns the learner.  The client hands out numpy
trees; the actor keeps one copy of them on its device and copies again only
when the client's params object changes.

A policy is written over a leading batch axis (``vmap`` of the reference,
written out): ``policy(params, generator, obs)`` takes stacked observations
``(N, ...)`` as a tensor on the actor's device and returns a tensor, or a
tuple of tensors, each with N rows.  ``FeedForwardActor`` calls it with
N = 1 and returns row 0; ``BatchedFeedForwardActor`` drives N environments
through ONE call per step and fans transitions out to N per-env adders via
the ``env_id`` argument on ``observe``/``observe_first``.

Random draws come from a ``torch.Generator`` on the actor's device, seeded
with ``seed * STEP_MOD + step`` before each call, as the reference folds
the step counter into its key on the device: a step's draws do not depend
on the steps before it, and the step counter is the whole RNG state.
Recurrent and inference-client actors come with later slices.
"""
from __future__ import annotations

import inspect
from typing import TYPE_CHECKING, Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.interfaces import Actor
from repro_torch.core.types import TimeStep
from repro_torch.core.variable import VariableClient

if TYPE_CHECKING:  # avoid core <-> adders circular import at runtime
    from repro_torch.adders.base import Adder

PolicyFn = Callable[..., Any]   # (params, generator, obs) -> action(s)

# Batch and step counters wrap here, so a seed derived from them stays in
# range however long a run lasts.
STEP_MOD = 2 ** 31


def adder_takes_extras(adder) -> bool:
    """Whether ``adder.add_first`` accepts a second ``extras`` argument.

    Prefers the adder's declared ``supports_extras`` attribute; falls back to
    an ``inspect.signature`` arity check for third-party adders.  This is an
    explicit capability probe — unlike calling ``add_first`` inside a
    ``try/except TypeError``, it can never swallow a real ``TypeError``
    raised by the adder's own implementation.
    """
    if adder is None:
        return False
    declared = getattr(adder, "supports_extras", None)
    if declared is not None:
        return bool(declared)
    try:
        params = inspect.signature(adder.add_first).parameters
    except (TypeError, ValueError):
        return False
    positional = [p for p in params.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    has_var = any(p.kind == p.VAR_POSITIONAL for p in params.values())
    return len(positional) >= 2 or has_var


def to_host(out):
    """A policy's output tensors as numpy arrays."""
    return tree.map(lambda x: x.cpu().numpy(), out)


class _PolicyRunner:
    """Runs ``policy`` on the device with the seeded per-step generator and
    the device copy of the client's params (shared by both actors)."""

    def __init__(self, policy: PolicyFn, variable_client: VariableClient,
                 rng_seed: int, device):
        self._policy = policy
        self._client = variable_client
        self._seed = int(rng_seed)
        self._device = torch.device(device)
        self._generator = torch.Generator(device=self._device)
        self._host_params = None
        self._params = None
        self.steps = 0

    def params(self):
        host = self._client.params
        if host is not self._host_params:
            self._params = tree.map(
                lambda x: torch.tensor(x, device=self._device), host)
            self._host_params = host
        return self._params

    def __call__(self, observation):
        self._generator.manual_seed(self._seed * STEP_MOD + self.steps)
        obs = torch.as_tensor(np.asarray(observation), device=self._device)
        out = self._policy(self.params(), self._generator, obs)
        self.steps = (self.steps + 1) % STEP_MOD
        return out


class FeedForwardActor(Actor):
    def __init__(self, policy: PolicyFn, variable_client: VariableClient,
                 adder: Optional["Adder"] = None, rng_seed: int = 0,
                 device="cuda"):
        self._run = _PolicyRunner(policy, variable_client, rng_seed, device)
        self._client = variable_client
        self._adder = adder

    def _run_policy(self, observation):
        """The policy's outputs for one observation, as row 0 on the host."""
        out = self._run(np.asarray(observation)[None])
        return tree.map(lambda x: x[0], to_host(out))

    def select_action(self, observation):
        return self._run_policy(observation)

    def observe_first(self, timestep: TimeStep):
        if self._adder:
            self._adder.add_first(timestep)

    def observe(self, action, next_timestep: TimeStep):
        if self._adder:
            self._adder.add(action, next_timestep)

    def update(self, wait: bool = False):
        self._client.update(wait)

    def state_dict(self):
        # steps is the whole RNG stream: each step's generator is seeded
        # from (seed, step).
        return {"steps": self._run.steps, "client": self._client.state_dict()}

    def load_state_dict(self, state):
        self._run.steps = int(state["steps"])
        self._client.load_state_dict(state["client"])


class BatchedFeedForwardActor(Actor):
    """N environments, ONE policy call per step.

    ``select_action`` takes stacked observations ``(N, ...)`` and returns N
    actions; ``observe``/``observe_first`` route each env's transitions to
    its own adder (``adders[env_id]``) so per-env experience streams are
    byte-identical to N single-env loops.
    """

    def __init__(self, policy: PolicyFn, variable_client: VariableClient,
                 adders: Optional[Sequence[Optional["Adder"]]] = None,
                 rng_seed: int = 0, device="cuda"):
        self._run = _PolicyRunner(policy, variable_client, rng_seed, device)
        self._client = variable_client
        self._adders = list(adders) if adders is not None else []

    def _adder(self, env_id: int) -> Optional["Adder"]:
        return self._adders[env_id] if env_id < len(self._adders) else None

    def _run_policy(self, observation):
        return to_host(self._run(observation))

    def select_action(self, observation):
        return self._run_policy(observation)

    def observe_first(self, timestep: TimeStep, env_id: int = 0):
        adder = self._adder(env_id)
        if adder:
            adder.add_first(timestep)

    def observe(self, action, next_timestep: TimeStep, env_id: int = 0):
        adder = self._adder(env_id)
        if adder:
            adder.add(action, next_timestep)

    def update(self, wait: bool = False):
        self._client.update(wait)

    def state_dict(self):
        return {"steps": self._run.steps, "client": self._client.state_dict()}

    def load_state_dict(self, state):
        self._run.steps = int(state["steps"])
        self._client.load_state_dict(state["client"])
