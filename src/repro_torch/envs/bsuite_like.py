"""bsuite-style capability probes (§4.7): memory chain and a stochastic bandit.

MemoryChain: the first observation contains a context bit; after N distractor
steps the agent must report it — only agents with memory (R2D2) can solve it.
Bandit: a single-step stochastic bandit probing basic credit assignment.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import types


class MemoryChain(types.Environment):
    def __init__(self, memory_length: int = 10, seed: int = 0):
        self.memory_length = memory_length
        self._rng = np.random.RandomState(seed)
        self._context = 0
        self._t = 0
        self._done = True

    def observation_spec(self):
        # [context (only at t=0), time fraction, query flag]
        return types.ArraySpec((3,), np.float32, "obs")

    def action_spec(self):
        return types.DiscreteArraySpec((), np.int32, "action", num_values=2)

    def _obs(self):
        ctx = self._context if self._t == 0 else 0.0
        query = 1.0 if self._t == self.memory_length else 0.0
        return np.array([ctx, self._t / self.memory_length, query], np.float32)

    def reset(self):
        self._context = int(self._rng.randint(2)) * 2 - 1   # -1 or +1
        self._t = 0
        self._done = False
        return types.restart(self._obs())

    def step(self, action):
        if self._done:
            return self.reset()
        self._t += 1
        if self._t == self.memory_length:
            self._done = True
            correct = (int(action) * 2 - 1) == self._context
            return types.termination(1.0 if correct else -1.0, self._obs())
        return types.transition(0.0, self._obs())


class Bandit(types.Environment):
    def __init__(self, num_arms: int = 11, seed: int = 0):
        self.num_arms = num_arms
        self._rng = np.random.RandomState(seed)
        self.means = np.linspace(0, 1, num_arms)
        self._rng.shuffle(self.means)

    def observation_spec(self):
        return types.ArraySpec((1,), np.float32, "obs")

    def action_spec(self):
        return types.DiscreteArraySpec((), np.int32, "action",
                                       num_values=self.num_arms)

    def reset(self):
        return types.restart(np.zeros(1, np.float32))

    def step(self, action):
        r = float(self._rng.rand() < self.means[int(action)])
        return types.termination(r, np.zeros(1, np.float32))
