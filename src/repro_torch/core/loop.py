"""The environment loop (Fig 2 of the paper, line-for-line) — and its
vectorized form, which drives N auto-resetting environments through a
batched actor with one policy call per N transitions."""
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


class VectorizedEnvironmentLoop:
    """The batched acting loop: N auto-resetting envs, one batched actor.

    Per tick the actor selects N actions in ONE batched policy call and
    the ``VectorEnv`` advances every member env; per-env transitions are
    then routed to per-env adders (``observe(..., env_id=i)``), with an
    env's ``observe_first`` fired at its auto-reset boundary — so each env's
    experience stream is exactly what a single ``EnvironmentLoop`` would
    have produced.

    Counter/logging semantics match the single loop: a result dict per
    COMPLETED episode, ``{label}_episodes``/``{label}_steps`` incremented at
    episode ends, and only real transitions counted (an auto-reset tick is
    not a transition).  ``update_period`` is in ticks — one tick already
    covers N env steps.

    ``run`` is RESUMABLE: episodes in flight when a call's
    ``num_episodes``/``num_steps`` budget expires stay in flight — the next
    call continues them instead of resetting the envs (so chunked drivers
    like ``run_experiment``'s eval cadence never truncate per-env adder
    streams or discard partial episodes).  The budgets themselves are
    per-call, matching ``EnvironmentLoop.run``.
    """

    def __init__(self, vector_env, actor,
                 counter: Optional[Counter] = None,
                 logger: Optional[Callable[[Dict[str, Any]], None]] = None,
                 label: str = "environment_loop",
                 should_update: bool = True,
                 update_period: int = 1):
        if update_period < 1:
            raise ValueError(f"update_period must be >= 1, "
                             f"got {update_period}")
        self._environment = vector_env
        self._actor = actor
        self._counter = counter or Counter()
        self._logger = logger
        self._label = label
        self._should_update = should_update
        self._update_period = update_period
        # carried across run() calls (resume support)
        self._ts = None
        self._ep_return = [0.0] * vector_env.num_envs
        self._ep_steps = [0] * vector_env.num_envs
        # monotonic: wall-clock adjustments must not yield negative rates
        self._ep_start = [time.monotonic()] * vector_env.num_envs
        self._ticks = 0

    # -- exact resume --------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Carried loop state: the tick counter (weight-sync cadence) and
        the per-env in-flight episode accumulators.  The batched timestep
        itself is NOT captured — the envs restore through ``VectorEnv.
        get_state``/``set_state`` and the next ``run()`` call re-derives
        the observation from them."""
        return {"ticks": self._ticks,
                "ep_return": list(self._ep_return),
                "ep_steps": list(self._ep_steps)}

    def load_state_dict(self, state: Dict[str, Any]):
        self._ticks = int(state["ticks"])
        self._ep_return = [float(r) for r in state["ep_return"]]
        self._ep_steps = [int(s) for s in state["ep_steps"]]

    def run(self, num_episodes: Optional[int] = None,
            num_steps: Optional[int] = None,
            should_stop: Optional[Callable[[], bool]] = None) -> List[Dict]:
        from repro_torch.envs.vector import split_timestep

        num_envs = self._environment.num_envs
        results: List[Dict] = []
        call_steps = 0

        if self._ts is None:   # first call only; later calls resume
            self._ts = self._environment.reset()
            now = time.monotonic()
            for i in range(num_envs):
                self._actor.observe_first(split_timestep(self._ts, i),
                                          env_id=i)
                self._ep_start[i] = now

        while True:
            if should_stop is not None and should_stop():
                break
            if num_episodes is not None and len(results) >= num_episodes:
                break
            if num_steps is not None and call_steps >= num_steps:
                break

            # ONE batched policy call for all N envs.
            actions = self._actor.select_action(self._ts.observation)
            self._ts = self._environment.step(actions)

            for i in range(num_envs):
                ts_i = split_timestep(self._ts, i)
                if ts_i.first():
                    # auto-reset boundary: a fresh episode starts for env i
                    self._actor.observe_first(ts_i, env_id=i)
                    self._ep_return[i], self._ep_steps[i] = 0.0, 0
                    self._ep_start[i] = time.monotonic()
                    continue
                self._actor.observe(actions[i], ts_i, env_id=i)
                self._ep_return[i] += ts_i.reward
                self._ep_steps[i] += 1
                call_steps += 1
                if ts_i.last():
                    counts = self._counter.increment(
                        **{f"{self._label}_episodes": 1,
                           f"{self._label}_steps": self._ep_steps[i]})
                    result = {
                        "episode_return": self._ep_return[i],
                        "episode_length": self._ep_steps[i],
                        "steps_per_second": self._ep_steps[i] / max(
                            time.monotonic() - self._ep_start[i], 1e-9),
                        "env_id": i,
                        **counts,
                    }
                    results.append(result)
                    if self._logger:
                        self._logger(result)

            self._ticks += 1
            if self._should_update and self._ticks % self._update_period == 0:
                self._actor.update()
        return results
