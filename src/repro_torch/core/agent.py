"""The synchronous learning agent (§2.2): an actor that owns a learner and
triggers learner steps from update(), governed by a local
min_observations / observations_per_step schedule (the single-process
equivalent of the rate limiter's SPI)."""
from __future__ import annotations

from typing import Optional

from repro_torch.core.interfaces import Actor, Learner
from repro_torch.core.types import TimeStep


class Agent(Actor):
    def __init__(self, actor: Actor, learner: Learner,
                 min_observations: int, observations_per_step: float,
                 can_step=None):
        self._actor = actor
        self._learner = learner
        self._min_observations = min_observations
        self._observations_per_step = observations_per_step
        self._num_observations = 0
        self._learner_steps_taken = 0
        # synchronous-safety guard: don't call a learner step that would
        # block on the dataset (queue not yet holding a full batch).
        self._can_step = can_step

    def select_action(self, observation):
        return self._actor.select_action(observation)

    def observe_first(self, timestep: TimeStep, **kwargs):
        self._actor.observe_first(timestep, **kwargs)

    def observe(self, action, next_timestep: TimeStep, **kwargs):
        self._num_observations += 1
        self._actor.observe(action, next_timestep, **kwargs)

    def update(self, wait: bool = False):
        # Step the learner up to the schedule's target for the observations
        # seen so far.  Target-based (rather than fire-on-modulo) so one
        # update() after a BATCH of observations — the vectorized loop calls
        # update once per N-env tick — runs the same number of learner steps
        # as N per-observation updates would have.
        n = self._num_observations - self._min_observations
        if n < 0:
            return
        if self._observations_per_step >= 1:
            target = n // int(self._observations_per_step) + 1
        else:
            target = (n + 1) * int(1 / self._observations_per_step)
        stepped = 0
        while self._learner_steps_taken < target:
            if self._can_step is not None and not self._can_step():
                break
            self._learner.step()
            self._learner_steps_taken += 1
            stepped += 1
        if stepped:
            self._actor.update()

    @property
    def learner(self) -> Learner:
        return self._learner

    @property
    def actor(self) -> Actor:
        return self._actor

    # -- exact resume --------------------------------------------------
    def state_dict(self):
        # The observation/step counters drive the target-based learner
        # schedule: restoring them keeps post-resume learner steps on
        # exactly the same observations as the uninterrupted run.
        return {"num_observations": self._num_observations,
                "learner_steps_taken": self._learner_steps_taken,
                "actor": self._actor.state_dict()}

    def load_state_dict(self, state):
        self._num_observations = int(state["num_observations"])
        self._learner_steps_taken = int(state["learner_steps_taken"])
        self._actor.load_state_dict(state["actor"])
