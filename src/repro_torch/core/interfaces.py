"""Acme's core abstractions: Actor, Learner, VariableSource (§2 of the paper)."""
from __future__ import annotations

import abc
from typing import Any, Dict, List, Sequence

from repro_torch.core.types import TimeStep


class VariableSource(abc.ABC):
    """Anything that can hand out named collections of variables (a learner)."""

    @abc.abstractmethod
    def get_variables(self, names: Sequence[str] = ()) -> List[Any]:
        ...


class Actor(abc.ABC):
    """Interacts with the environment: Fig 2's select_action/observe/update."""

    @abc.abstractmethod
    def select_action(self, observation) -> Any:
        ...

    @abc.abstractmethod
    def observe_first(self, timestep: TimeStep):
        ...

    @abc.abstractmethod
    def observe(self, action, next_timestep: TimeStep):
        ...

    @abc.abstractmethod
    def update(self, wait: bool = False):
        """Pull fresh weights / trigger learner steps (agents)."""
        ...

    # -- exact resume (repro.resilience) -------------------------------
    # Actors carry only small host-side state (RNG step counters); the
    # default is stateless.  Overrides must round-trip everything that
    # influences future action draws, captured at an episode boundary.
    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]):
        pass


class Learner(VariableSource, abc.ABC):
    """Consumes batches, runs SGD (§2.2)."""

    @abc.abstractmethod
    def step(self) -> Dict[str, Any]:
        """One learner step; returns metrics."""
        ...

    def run(self, num_steps: int) -> Dict[str, Any]:
        metrics = {}
        for _ in range(num_steps):
            metrics = self.step()
        return metrics


class Worker(abc.ABC):
    """A runnable node in a distributed program (Launchpad-lite)."""

    @abc.abstractmethod
    def run(self):
        ...
