"""Transition and n-step-transition adders (DQN/DDPG-family, §3.2).

``NStepTransitionAdder`` stores overlapping n-step transitions
(o_t, a_t, sum_i gamma^i r_{t+i}, prod discounts, o_{t+n}) — "functionally
equivalent to single-step transitions and using the same storage" as the
paper notes.  Priorities default to max-priority-on-insert so prioritized
tables sample fresh data first.
"""
from __future__ import annotations

from collections import deque
from typing import Any

import numpy as np

from repro_torch.adders.base import Adder
from repro_torch.core.types import TimeStep, Transition
from repro_torch.replay.table import Table


class NStepTransitionAdder(Adder):
    def __init__(self, table: Table, n_step: int = 1, discount: float = 0.99,
                 priority: float = 1.0):
        self.table = table
        self.n = int(n_step)
        self.gamma = float(discount)
        self.default_priority = priority
        self._buffer: deque = deque()
        self._obs = None

    def reset(self):
        self._buffer.clear()
        self._obs = None

    def add_first(self, timestep: TimeStep):
        self.reset()
        self._obs = timestep.observation

    def add(self, action, next_timestep: TimeStep, extras: Any = ()):
        if self._obs is None:
            raise RuntimeError("add() before add_first()")
        self._buffer.append(
            (self._obs, action, float(next_timestep.reward),
             float(next_timestep.discount), extras))
        self._obs = next_timestep.observation

        if len(self._buffer) == self.n:
            self._write(next_timestep.observation)
            self._buffer.popleft()
        if next_timestep.last():
            # flush the remaining (shorter) transitions at episode end
            while self._buffer:
                self._write(next_timestep.observation)
                self._buffer.popleft()
            self._obs = None

    def _write(self, next_obs):
        obs, action, _, _, extras = self._buffer[0]
        r, g = 0.0, 1.0
        for (_, _, rew, disc, _) in self._buffer:
            r += g * rew
            g *= self.gamma * disc
        item = Transition(np.asarray(obs), np.asarray(action),
                          np.float32(r), np.float32(g),
                          np.asarray(next_obs), extras)
        self.table.insert(item, priority=self.default_priority)


class TransitionAdder(NStepTransitionAdder):
    def __init__(self, table: Table, discount: float = 0.99, priority: float = 1.0):
        super().__init__(table, n_step=1, discount=discount, priority=priority)
