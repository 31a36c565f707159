"""Token-MDP environment: the bridge between the RL framework and the
large-model zoo.  The 'environment' emits token observations from a synthetic
Markov language (a random n-gram chain); actions are next-token predictions
and reward is log-likelihood-style (+1 exact match, partial credit by chain
proximity).  This is the environment used by the transformer-policy examples
and the offline-dataset generator for the BC learner.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import types


class TokenChain(types.Environment):
    def __init__(self, vocab_size: int = 256, order: int = 2,
                 episode_len: int = 64, seed: int = 0):
        self.vocab = vocab_size
        self.order = order
        self.episode_len = episode_len
        rng = np.random.RandomState(seed)
        # deterministic successor table: context hash -> next token
        self._succ = rng.randint(0, vocab_size, size=(vocab_size * order,))
        self._ctx = None
        self._t = 0

    def observation_spec(self):
        return types.ArraySpec((self.order,), np.int32, "context")

    def action_spec(self):
        return types.DiscreteArraySpec((), np.int32, "action",
                                       num_values=self.vocab)

    def _next_token(self):
        h = 0
        for i, t in enumerate(self._ctx):
            h = (h + (i + 1) * int(t)) % (self.vocab * self.order)
        return int(self._succ[h])

    def reset(self):
        self._ctx = np.zeros(self.order, np.int32)
        self._t = 0
        return types.restart(self._ctx.copy())

    def step(self, action):
        target = self._next_token()
        reward = 1.0 if int(action) == target else 0.0
        self._ctx = np.roll(self._ctx, -1)
        self._ctx[-1] = target
        self._t += 1
        if self._t >= self.episode_len:
            return types.termination(reward, self._ctx.copy())
        return types.transition(reward, self._ctx.copy())
