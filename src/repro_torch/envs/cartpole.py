"""Continuous-control tasks (control-suite-like, §4.3): cartpole swingup and
pendulum swingup with real physics integration, continuous action spaces, and
1000-step episodes with per-step rewards in [0, 1] (100-ish best returns when
scaled, matching the paper's 'theoretical limit' framing)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import types


class CartpoleSwingup(types.Environment):
    """Classic cart-pole swingup from raw features (5-dim obs, 1-dim action)."""

    def __init__(self, seed: int = 0, episode_len: int = 1000):
        self._rng = np.random.RandomState(seed)
        self.episode_len = episode_len
        self.dt = 0.01
        self.masscart, self.masspole, self.length = 1.0, 0.1, 0.5
        self.gravity = 9.8
        self._t = 0
        self._state = None          # x, x_dot, theta, theta_dot

    def observation_spec(self):
        return types.ArraySpec((5,), np.float32, "features")

    def action_spec(self):
        return types.BoundedArraySpec((1,), np.float32, "force", -1.0, 1.0)

    def _obs(self):
        x, xd, th, thd = self._state
        return np.array([x, xd, np.cos(th), np.sin(th), thd], np.float32)

    def reset(self):
        self._t = 0
        self._state = np.array(
            [0.0, 0.0, np.pi + self._rng.uniform(-0.1, 0.1), 0.0])
        return types.restart(self._obs())

    def step(self, action):
        force = 10.0 * float(np.clip(np.asarray(action).reshape(-1)[0], -1, 1))
        x, xd, th, thd = self._state
        for _ in range(2):  # substeps
            total_m = self.masscart + self.masspole
            pm_l = self.masspole * self.length
            sin, cos = np.sin(th), np.cos(th)
            temp = (force + pm_l * thd ** 2 * sin) / total_m
            th_acc = (self.gravity * sin - cos * temp) / (
                self.length * (4.0 / 3.0 - self.masspole * cos ** 2 / total_m))
            x_acc = temp - pm_l * th_acc * cos / total_m
            x += self.dt * xd
            xd += self.dt * x_acc
            th += self.dt * thd
            thd += self.dt * th_acc
            xd *= 0.999
            thd *= 0.999
        x = float(np.clip(x, -2.4, 2.4))
        self._state = np.array([x, xd, th, thd])
        self._t += 1
        # reward: pole upright and cart centered
        upright = (np.cos(th) + 1.0) / 2.0
        centered = 1.0 - abs(x) / 2.4
        reward = float(upright * (0.5 + 0.5 * centered))
        if self._t >= self.episode_len:
            return types.truncation(reward, self._obs())
        return types.transition(reward, self._obs())


class PendulumSwingup(types.Environment):
    """Torque-limited pendulum swingup (3-dim obs, 1-dim action)."""

    def __init__(self, seed: int = 0, episode_len: int = 500):
        self._rng = np.random.RandomState(seed)
        self.episode_len = episode_len
        self.dt = 0.05
        self.g, self.m, self.l = 10.0, 1.0, 1.0
        self.max_torque = 2.0
        self._t = 0
        self._state = None          # theta, theta_dot

    def observation_spec(self):
        return types.ArraySpec((3,), np.float32, "features")

    def action_spec(self):
        return types.BoundedArraySpec((1,), np.float32, "torque", -1.0, 1.0)

    def _obs(self):
        th, thd = self._state
        return np.array([np.cos(th), np.sin(th), thd / 8.0], np.float32)

    def reset(self):
        self._t = 0
        self._state = np.array([np.pi + self._rng.uniform(-0.1, 0.1), 0.0])
        return types.restart(self._obs())

    def step(self, action):
        u = self.max_torque * float(np.clip(np.asarray(action).reshape(-1)[0], -1, 1))
        th, thd = self._state
        thd = thd + (3 * self.g / (2 * self.l) * np.sin(th)
                     + 3.0 / (self.m * self.l ** 2) * u) * self.dt
        thd = float(np.clip(thd, -8, 8))
        th = th + thd * self.dt
        self._state = np.array([th, thd])
        self._t += 1
        reward = float((np.cos(th) + 1.0) / 2.0)
        if self._t >= self.episode_len:
            return types.truncation(reward, self._obs())
        return types.transition(reward, self._obs())
