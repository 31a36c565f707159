"""Deep Sea (bsuite): the canonical hard-exploration task (§4.8 of the paper).

An NxN grid; the agent starts top-left, always descends one row, and moves
left/right.  Only the far-right bottom cell pays +1; every 'right' move costs
0.01/N.  Random policies find the treasure with probability 2^-N.  The
stochastic variant flips the effective action with probability 1/N.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import types


class DeepSea(types.Environment):
    def __init__(self, size: int = 10, stochastic: bool = False, seed: int = 0):
        self.size = size
        self.stochastic = stochastic
        self._rng = np.random.RandomState(seed)
        # fixed random action mapping per column (as in bsuite)
        self._action_map = self._rng.binomial(1, 0.5, (size, size))
        self._row = 0
        self._col = 0
        self._done = True

    def observation_spec(self):
        return types.ArraySpec((self.size, self.size), np.float32, "grid")

    def action_spec(self):
        return types.DiscreteArraySpec((), np.int32, "action", num_values=2)

    def _obs(self):
        o = np.zeros((self.size, self.size), np.float32)
        if self._row < self.size:
            o[self._row, self._col] = 1.0
        return o

    def reset(self):
        self._row = self._col = 0
        self._done = False
        return types.restart(self._obs())

    def optimal_action(self) -> int:
        """The action whose mapped effect is 'right' in the current cell."""
        go_right = 1
        mapped = self._action_map[self._row, self._col]
        return int(go_right == mapped)

    def step(self, action):
        if self._done:
            return self.reset()
        a = int(action)
        # action semantics per-cell (bsuite's action mapping)
        go_right = (a == self._action_map[self._row, self._col])
        if self.stochastic and self._rng.rand() < 1.0 / self.size:
            go_right = not go_right
        reward = 0.0
        if go_right:
            reward -= 0.01 / self.size
            self._col = min(self._col + 1, self.size - 1)
        else:
            self._col = max(self._col - 1, 0)
        self._row += 1
        if self._row == self.size:
            self._done = True
            if go_right and self._col == self.size - 1:
                reward += 1.0
            return types.termination(reward, self._obs())
        return types.transition(reward, self._obs())
