"""Catch (bsuite): a falling ball must be caught by a paddle. Discrete."""
from __future__ import annotations

import numpy as np

from repro_torch.core import types


class Catch(types.Environment):
    def __init__(self, rows: int = 10, columns: int = 5, seed: int = 0):
        self.rows, self.columns = rows, columns
        self._rng = np.random.RandomState(seed)
        self._ball = None
        self._paddle = None
        self._done = True

    def observation_spec(self):
        return types.ArraySpec((self.rows, self.columns), np.float32, "board")

    def action_spec(self):
        return types.DiscreteArraySpec((), np.int32, "action", num_values=3)

    def _board(self):
        b = np.zeros((self.rows, self.columns), np.float32)
        r, c = self._ball
        if r < self.rows:
            b[r, c] = 1.0
        b[self.rows - 1, self._paddle] = 1.0
        return b

    def reset(self):
        self._ball = [0, int(self._rng.randint(self.columns))]
        self._paddle = self.columns // 2
        self._done = False
        return types.restart(self._board())

    # -- exact resume (repro.resilience) -------------------------------
    def get_state(self):
        """Everything a bit-exact resume needs: the ball-column RNG stream
        and the board position (captured at episode boundaries, where
        done=True and ball/paddle are about to be re-rolled)."""
        return {"rng": self._rng.get_state(),
                "ball": None if self._ball is None else list(self._ball),
                "paddle": self._paddle,
                "done": self._done}

    def set_state(self, state):
        self._rng.set_state(state["rng"])
        self._ball = None if state["ball"] is None else list(state["ball"])
        self._paddle = state["paddle"]
        self._done = state["done"]

    def step(self, action):
        if self._done:
            return self.reset()
        self._paddle = int(np.clip(self._paddle + int(action) - 1,
                                   0, self.columns - 1))
        self._ball[0] += 1
        if self._ball[0] == self.rows - 1:
            self._done = True
            reward = 1.0 if self._ball[1] == self._paddle else -1.0
            return types.termination(reward, self._board())
        return types.transition(0.0, self._board())
