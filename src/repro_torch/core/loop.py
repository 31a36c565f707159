"""The environment loop (Fig 2 of the paper, line-for-line).  The
vectorized loop comes with the batched-acting slice."""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.interfaces import Actor
from repro_torch.core.types import Environment


class Counter:
    """Shared step/episode counters (actor steps vs evaluator steps, §4.2)."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self._counts: Dict[str, float] = {}

    def increment(self, **deltas) -> Dict[str, float]:
        with self._lock:
            for k, v in deltas.items():
                self._counts[k] = self._counts.get(k, 0) + v
            return dict(self._counts)

    def get_counts(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counts)

    def set_counts(self, counts: Dict[str, float]):
        """Replace all totals (exact resume: restored from a checkpoint)."""
        with self._lock:
            self._counts = dict(counts)

    # Recoverable-protocol aliases: the counter service snapshots and
    # restores like any other stateful service.
    def state_dict(self) -> Dict[str, float]:
        return self.get_counts()

    def load_state_dict(self, counts: Dict[str, float]):
        self.set_counts(counts)


class EnvironmentLoop:
    def __init__(self, environment: Environment, actor: Actor,
                 counter: Optional[Counter] = None,
                 logger: Optional[Callable[[Dict[str, Any]], None]] = None,
                 label: str = "environment_loop",
                 should_update: bool = True,
                 update_period: int = 1):
        if update_period < 1:
            raise ValueError(f"update_period must be >= 1, "
                             f"got {update_period}")
        self._environment = environment
        self._actor = actor
        self._counter = counter or Counter()
        self._logger = logger
        self._label = label
        self._should_update = should_update
        # actor.update() cadence in env steps: pure actors polling a remote
        # VariableClient need not be poked every single step (the client's
        # own update_period then applies to far fewer calls).  Synchronous
        # Agents keep the default of 1 — update() drives their learner.
        self._update_period = update_period
        self._update_calls = 0

    # -- exact resume --------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"update_calls": self._update_calls}

    def load_state_dict(self, state: Dict[str, Any]):
        self._update_calls = int(state["update_calls"])

    def run_episode(self) -> Dict[str, Any]:
        episode_return = 0.0
        episode_steps = 0
        # monotonic: wall-clock adjustments must not yield negative rates
        start = time.monotonic()

        # Make an initial observation.
        step = self._environment.reset()
        self._actor.observe_first(step)

        while not step.last():
            # Evaluate the policy and take a step in the environment.
            action = self._actor.select_action(step.observation)
            step = self._environment.step(action)

            # Make an observation and update the actor.
            self._actor.observe(action, next_timestep=step)
            if self._should_update:
                self._update_calls += 1
                if self._update_calls % self._update_period == 0:
                    self._actor.update()

            episode_return += step.reward
            episode_steps += 1

        counts = self._counter.increment(
            **{f"{self._label}_episodes": 1,
               f"{self._label}_steps": episode_steps})
        result = {
            "episode_return": episode_return,
            "episode_length": episode_steps,
            "steps_per_second": episode_steps / max(
                time.monotonic() - start, 1e-9),
            **counts,
        }
        if self._logger:
            self._logger(result)
        return result

    def run(self, num_episodes: Optional[int] = None,
            num_steps: Optional[int] = None,
            should_stop: Optional[Callable[[], bool]] = None) -> List[Dict]:
        results = []
        steps = 0
        episodes = 0
        while True:
            if should_stop is not None and should_stop():
                break
            if num_episodes is not None and episodes >= num_episodes:
                break
            if num_steps is not None and steps >= num_steps:
                break
            result = self.run_episode()
            results.append(result)
            episodes += 1
            steps += result["episode_length"]
        return results
