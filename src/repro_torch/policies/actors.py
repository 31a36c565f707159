"""Actors that feed observation windows to a transformer policy.

All three actors keep the same tiny piece of host state per environment —
a ``_WindowBuffer`` holding the last W observations left-aligned — and
differ only in where the forward pass runs:

- ``WindowedPolicyActor``: single env, local ``PolicyEngine`` (one cache
  slot) — incremental KV-cache decode without any server.
- ``BatchedWindowedPolicyActor``: N envs through one engine call per tick
  (the vectorized-acting contract of ``BatchedFeedForwardActor``).
- ``WindowedInferenceClientActor``: SEED-style client; windows go to a
  ``TransformerInferenceServer`` which owns weights, caches, and the CUDA
  decode kernel.

Cache-slot keys are stable per environment; episode ends need no RPC —
the engine sees the position drop back to 0 (≠ ``slot.pos + 1``) and
recycles the slot in place via the prefill path.
"""
from __future__ import annotations

import uuid
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.interfaces import Actor
from repro_torch.core.types import TimeStep


class _WindowBuffer:
    """Last-W-observations buffer, materialized LEFT-aligned (oldest first,
    zero-padded on the right) — the layout ``PolicyEngine.select`` and the
    learner's replayed sequences share."""

    def __init__(self, window: int, obs_shape):
        self.window = window
        self.obs_shape = tuple(obs_shape)
        self.frames = []
        self.t = -1               # episode step of the newest frame

    def reset(self):
        self.frames = []
        self.t = -1

    def push(self, observation):
        self.frames.append(np.asarray(observation, np.float32))
        if len(self.frames) > self.window:
            self.frames.pop(0)
        self.t += 1

    def window_array(self) -> np.ndarray:
        out = np.zeros((self.window,) + self.obs_shape, np.float32)
        for i, f in enumerate(self.frames):
            out[i] = f
        return out


class WindowedPolicyActor(Actor):
    """Single-env local acting through a one-slot ``PolicyEngine``: the
    same incremental-decode hot path as the server, minus the RPC."""

    def __init__(self, engine, variable_client, adder=None):
        self._engine = engine
        self._client = variable_client
        self._adder = adder
        self._buffer = _WindowBuffer(engine.window, engine.obs_shape)

    def select_action(self, observation):
        self._buffer.push(observation)
        actions = self._engine.select(
            self._client.params, ["env0"],
            self._buffer.window_array()[None], [self._buffer.t])
        return actions[0]

    def observe_first(self, timestep: TimeStep):
        self._buffer.reset()
        if self._adder:
            self._adder.add_first(timestep)

    def observe(self, action, next_timestep: TimeStep):
        if self._adder:
            self._adder.add(action, next_timestep)

    def update(self, wait: bool = False):
        self._client.update(wait)


class BatchedWindowedPolicyActor(Actor):
    """N envs, one ``PolicyEngine.select`` per tick (vectorized acting)."""

    def __init__(self, engine, variable_client, adders):
        self._engine = engine
        self._client = variable_client
        self._adders = list(adders)
        self._buffers = [_WindowBuffer(engine.window, engine.obs_shape)
                         for _ in range(len(self._adders))]

    def _adder(self, env_id: int):
        return self._adders[env_id] if env_id < len(self._adders) else None

    def select_action(self, observation):
        obs = np.asarray(observation)
        keys, windows, positions = [], [], []
        for i in range(obs.shape[0]):
            self._buffers[i].push(obs[i])
            keys.append(f"env{i}")
            windows.append(self._buffers[i].window_array())
            positions.append(self._buffers[i].t)
        return self._engine.select(self._client.params, keys,
                                   np.stack(windows), positions)

    def observe_first(self, timestep: TimeStep, env_id: int = 0):
        self._buffers[env_id].reset()
        adder = self._adder(env_id)
        if adder:
            adder.add_first(timestep)

    def observe(self, action, next_timestep: TimeStep, env_id: int = 0):
        adder = self._adder(env_id)
        if adder:
            adder.add(action, next_timestep)

    def update(self, wait: bool = False):
        self._client.update(wait)


class WindowedInferenceClientActor(Actor):
    """SEED-style client for ``TransformerInferenceServer``: windows and
    episode steps go over ``select_action(windows, positions, client_id)``;
    the server's engine keys cache slots by ``(client_id, env_id)``, so the
    whole slot lifecycle lives server-side.  ``update`` is a no-op — the
    server owns the weights."""

    def __init__(self, inference, adder=None, adders=None,
                 batched: bool = False):
        if adder is not None and adders is not None:
            raise ValueError("pass either adder= or adders=, not both")
        self._inference = inference
        self._adders = list(adders) if adders is not None \
            else ([adder] if adder is not None else [])
        self._batched = batched
        self._client_id = uuid.uuid4().hex
        self._buffers: Optional[Sequence[_WindowBuffer]] = None

    def _adder(self, env_id: int):
        return self._adders[env_id] if env_id < len(self._adders) else None

    def _ensure_buffers(self, obs_shape, num_envs: int):
        if self._buffers is None:
            window = int(self._inference.window())
            self._buffers = [_WindowBuffer(window, obs_shape)
                             for _ in range(num_envs)]

    def select_action(self, observation):
        obs = np.asarray(observation, np.float32)
        if not self._batched:
            obs = obs[None]
        self._ensure_buffers(obs.shape[1:], obs.shape[0])
        windows, positions = [], []
        for i in range(obs.shape[0]):
            self._buffers[i].push(obs[i])
            windows.append(self._buffers[i].window_array())
            positions.append(self._buffers[i].t)
        actions = np.asarray(self._inference.select_action(
            np.stack(windows), np.asarray(positions, np.int64),
            self._client_id))
        return actions if self._batched else actions[0]

    def observe_first(self, timestep: TimeStep, env_id: int = 0):
        if self._buffers is not None:
            self._buffers[env_id].reset()
        adder = self._adder(env_id)
        if adder:
            adder.add_first(timestep)

    def observe(self, action, next_timestep: TimeStep, env_id: int = 0):
        adder = self._adder(env_id)
        if adder:
            adder.add(action, next_timestep)

    def update(self, wait: bool = False):
        pass   # the TransformerInferenceServer owns the weights
