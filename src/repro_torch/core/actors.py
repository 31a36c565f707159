"""Generic actors (§2.3): feed-forward, recurrent, and their batched forms.

A ``FeedForwardActor`` evaluates a policy function and forwards its
observations to an adder; a ``RecurrentActor`` additionally threads a
recurrent core state between ``select_action`` calls and hands the state
at episode starts to its adder as numpy extras (R2D2's stale-state
mechanism).  Both pull weights from a ``VariableClient`` on ``update()`` —
they never own the learner.  The client hands out numpy trees; an actor
keeps one copy of them on its device and copies again only when the
client's params object changes.

A policy is written over a leading batch axis (``vmap`` of the reference,
written out): ``policy(params, generator, obs)`` takes stacked observations
``(N, ...)`` as a tensor on the actor's device and returns a tensor, or a
tuple of tensors, each with N rows.  ``FeedForwardActor`` calls it with
N = 1 and returns row 0; ``BatchedFeedForwardActor`` drives N environments
through ONE call per step and fans transitions out to N per-env adders via
the ``env_id`` argument on ``observe``/``observe_first``.  A recurrent
policy takes and returns the core state too, ``policy(params, generator,
obs, state) -> (actions, state)``, each state leaf with N rows.

Random draws come from a ``torch.Generator`` on the actor's device, seeded
with ``seed * STEP_MOD + step`` before each call, as the reference folds
the step counter into its key on the device: a step's draws do not depend
on the steps before it, and the step counter is the whole RNG state.
The inference-client actor comes with the distributed slice.
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

PolicyFn = Callable[..., Any]   # (params, generator, obs[, state]) -> ...

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

    def __call__(self, observation, *rest):
        self._generator.manual_seed(self._seed * STEP_MOD + self.steps)
        obs = torch.as_tensor(np.asarray(observation), device=self._device)
        out = self._policy(self.params(), self._generator, obs, *rest)
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


class RecurrentActor(Actor):
    """One environment through a recurrent policy: the core state, on the
    actor's device, starts from ``initial_state_fn()`` (one row) at each
    episode and goes through every ``select_action`` call."""

    def __init__(self, policy: PolicyFn, initial_state_fn: Callable[[], Any],
                 variable_client: VariableClient,
                 adder: Optional["Adder"] = None, rng_seed: int = 0,
                 store_state: bool = True, device="cuda"):
        self._run = _PolicyRunner(policy, variable_client, rng_seed, device)
        self._initial_state_fn = initial_state_fn
        self._client = variable_client
        self._adder = adder
        self._adder_extras = adder_takes_extras(adder)
        self._state = None
        self._store_state = store_state

    def select_action(self, observation):
        if self._state is None:
            self._state = self._initial_state_fn()
        action, self._state = self._run(np.asarray(observation)[None],
                                        self._state)
        return to_host(action)[0]

    def observe_first(self, timestep: TimeStep):
        self._state = self._initial_state_fn()
        if self._adder:
            if self._adder_extras and self._store_state:
                # the state at the sequence's start, as numpy
                self._adder.add_first(timestep, to_host(self._state))
            else:
                self._adder.add_first(timestep)

    def observe(self, action, next_timestep: TimeStep):
        if self._adder:
            self._adder.add(action, next_timestep)

    def update(self, wait: bool = False):
        self._client.update(wait)

    def state_dict(self):
        # Captured at an episode boundary, so the recurrent core state is
        # about to be re-initialized by observe_first — only the RNG step
        # counter and weight-fetch cadence need to survive.
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


class BatchedRecurrentActor(BatchedFeedForwardActor):
    """Batched recurrent acting: the core state of N envs, N rows a leaf,
    threaded through one policy call; an env's row resets on that env's
    ``observe_first`` (the auto-reset boundary)."""

    def __init__(self, policy: PolicyFn, initial_state_fn: Callable[[], Any],
                 variable_client: VariableClient,
                 adders: Optional[Sequence[Optional["Adder"]]] = None,
                 rng_seed: int = 0, store_state: bool = True,
                 device="cuda"):
        super().__init__(policy, variable_client, adders, rng_seed, device)
        self._initial_state_fn = initial_state_fn
        self._store_state = store_state
        self._state = None
        self._adders_extras = [adder_takes_extras(a) for a in self._adders]

    def _stacked_initial_state(self, num_envs: int):
        """``initial_state_fn()``'s one row, repeated for each env."""
        return tree.map(lambda x: torch.cat([x] * num_envs),
                        self._initial_state_fn())

    def select_action(self, observation):
        observation = np.asarray(observation)
        if self._state is None:
            self._state = self._stacked_initial_state(observation.shape[0])
        actions, self._state = self._run(observation, self._state)
        return to_host(actions)

    def observe_first(self, timestep: TimeStep, env_id: int = 0):
        if self._state is not None:
            # reset just this env's row of the stacked core state
            for row, init in zip(tree.leaves(self._state),
                                 tree.leaves(self._initial_state_fn())):
                row[env_id] = init[0]
        adder = self._adder(env_id)
        if adder:
            if (env_id < len(self._adders_extras)
                    and self._adders_extras[env_id] and self._store_state):
                adder.add_first(timestep, to_host(self._initial_state_fn()))
            else:
                adder.add_first(timestep)
