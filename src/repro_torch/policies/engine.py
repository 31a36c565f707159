"""The policy-serving engine: routing between prefill and incremental decode.

``select`` takes one batch of (episode key, observation window, episode
step) rows — from any mix of clients — and answers every row with an
eps-greedy action while keeping each episode's KV-cache slot current:

- a row whose slot is CURRENT (same weights generation, step exactly one
  past the slot's last step) takes the DECODE path: one token through the
  cache, on the CUDA ``decode_attention`` kernel by default on the card;
- every other row (new episode, episode restart, dropped step, or weights
  refreshed since the slot was filled) takes the PREFILL path: its whole
  window is pushed through the cache in one batched call.

Both paths gather the group's slot rows from the pool's batched cache, run
ONE forward pass padded to a power-of-two bucket (pad rows ride the pool's
scratch slot), and scatter the updated rows back — continuous batching over
per-episode cache state.  Each pass moves its inputs to the device once and
brings its answer back in ONE device-to-host copy; no layer syncs.

Weight refresh detection is object identity on ``params`` (a
``VariableClient`` only rebinds ``.params`` when it actually fetched new
weights): a refresh bumps the pool generation, so every live slot
re-prefills before its next decode rather than mixing stale K/V into fresh
queries.  ``params`` may be tensors or the numpy trees a learner hands its
clients; the engine copies them to its device once per refresh.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.actors import STEP_MOD
from repro_torch.models.config import ArchConfig
from repro_torch.policies import network
from repro_torch.policies.cache import KVCachePool
from repro_torch.telemetry import registry as _telemetry


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class PolicyEngine:
    """Stateful transformer-policy evaluation over a ``KVCachePool`` on
    ``device``."""

    def __init__(self, arch: ArchConfig, obs_shape, num_actions: int, *,
                 num_slots: int, epsilon: float = 0.0,
                 backend: str = "auto", slot_timeout_s: float = 5.0,
                 rng_seed: int = 0, device="cuda"):
        self.arch = arch
        self.window = arch.sliding_window
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = int(np.prod(obs_shape)) or 1
        self.num_actions = num_actions
        self.epsilon = float(epsilon)
        self.backend = backend
        self.device = torch.device(device)
        self.pool = KVCachePool(arch, num_slots, timeout_s=slot_timeout_s,
                                device=self.device)
        # Exploration draws for batch ``step`` come from a generator seeded
        # with (rng_seed, step), as the reference folds the step into its
        # key: a batch's draws do not depend on the batches before it.
        self._rng_seed = int(rng_seed)
        self._generator = torch.Generator(device=self.device)
        self._step = 0
        self._last_params = None
        self._params = None           # _last_params on the device
        self._stats = {"prefill_rows": 0, "decode_rows": 0,
                       "prefill_batches": 0, "decode_batches": 0,
                       "cache_invalidations": 0, "stale_reprefills": 0}
        # Exported as gauges at snapshot time (no-op when telemetry is off);
        # covers slot utilization, prefill/decode ratio, re-prefill counts.
        _telemetry.probe("inference/engine", self.stats)
        # Host time of each pass, ending in its one device-to-host copy
        # (null, and the clock unread, when telemetry is off).
        self._m_prefill_ms = _telemetry.histogram("inference/engine/prefill_ms")
        self._m_decode_ms = _telemetry.histogram("inference/engine/decode_ms")

    # ------------------------------------------------------------ the passes
    def _eps_greedy(self, q, step):
        self._generator.manual_seed(self._rng_seed * STEP_MOD + step)
        rows = q.shape[0]
        greedy = torch.argmax(q, dim=-1)
        rand = torch.randint(0, self.num_actions, (rows,),
                             generator=self._generator, device=self.device)
        explore = torch.rand((rows,), generator=self._generator,
                             device=self.device) < self.epsilon
        return torch.where(explore, rand, greedy)

    def _answer(self, actions, q) -> Tuple[np.ndarray, np.ndarray]:
        """Actions and Q-values to the host in one copy."""
        both = torch.cat([actions[:, None].float(), q.float()], dim=1).cpu()
        both = both.numpy()
        return both[:, 0].astype(np.int32), both[:, 1:]

    def _prefill(self, params, sub_cache, windows, lengths, step):
        obs = windows.reshape(windows.shape[0], windows.shape[1], -1)
        q, sub_cache = network.q_prefill(params, self.arch, sub_cache, obs,
                                         lengths)
        rows = torch.arange(q.shape[0], device=self.device)
        q_last = q[rows, torch.clamp(lengths - 1, min=0)]
        return self._eps_greedy(q_last, step), q_last, sub_cache

    def _decode(self, params, sub_cache, obs, pos, step):
        obs = obs.reshape(obs.shape[0], -1)
        q, sub_cache = network.q_decode(params, self.arch, sub_cache, obs,
                                        pos, backend=self.backend)
        return self._eps_greedy(q, step), q, sub_cache

    # ----------------------------------------------------------- the hot path
    def select(self, params, keys: Sequence, windows, positions) -> np.ndarray:
        """One action per row.

        keys: hashable per-episode identities; windows: (n, W, *obs_shape)
        float32, LEFT-aligned (oldest frame first) and zero-padded on the
        right; positions: (n,) int — the EPISODE step of each row's newest
        frame.  Returns (n,) int32 actions.
        """
        return self.select_with_q(params, keys, windows, positions)[0]

    @torch.no_grad()
    def select_with_q(self, params, keys: Sequence, windows, positions
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """``select``, also returning each row's Q-values (n, A) float32."""
        if params is not self._last_params:
            if self._last_params is not None:
                self.pool.invalidate_all()
                self._stats["cache_invalidations"] += 1
            self._last_params = params
            self._params = tree.map(
                lambda x: torch.as_tensor(x, device=self.device), params)
        params = self._params

        windows = np.asarray(windows, np.float32)
        positions = np.asarray(positions, np.int64)
        n = windows.shape[0]
        generation = self.pool.generation
        actions = np.zeros((n,), np.int32)
        q_values = np.zeros((n, self.num_actions), np.float32)

        prefill_rows: List[int] = []
        decode_rows: List[int] = []
        slots = []
        for i in range(n):
            slot = self.pool.lookup(keys[i])
            if (slot is not None and slot.generation == generation
                    and slot.pos >= 0 and positions[i] == slot.pos + 1):
                decode_rows.append(i)
            else:
                if slot is None:
                    slot = self.pool.acquire(keys[i])
                else:
                    # episode restart or stale cache: recycle in place
                    if slot.generation != generation:
                        self._stats["stale_reprefills"] += 1
                    self.pool.reset_slot(slot)
                prefill_rows.append(i)
            slots.append(slot)

        if prefill_rows:
            self._run_prefill(params, prefill_rows, slots, windows,
                              positions, actions, q_values)
        if decode_rows:
            self._run_decode(params, decode_rows, slots, windows,
                             positions, actions, q_values)
        return actions, q_values

    def _pad(self, indices: List[int], bucket: int) -> torch.Tensor:
        scratch = self.pool.scratch_index
        return torch.as_tensor(indices + [scratch] * (bucket - len(indices)),
                               device=self.device)

    def _next_step(self) -> int:
        step = self._step
        self._step = (self._step + 1) % STEP_MOD
        return step

    def _run_prefill(self, params, rows, slots, windows, positions, actions,
                     q_values):
        t0 = time.monotonic() if self._m_prefill_ms else 0.0
        g = len(rows)
        bucket = _bucket(g)
        w = self.window
        lengths = np.ones((bucket,), np.int64)
        batch = np.zeros((bucket, w) + windows.shape[2:], np.float32)
        for j, i in enumerate(rows):
            lengths[j] = min(positions[i] + 1, w)
            batch[j] = windows[i]
        # every upload before the first kernel, while the stream is idle
        idx = self._pad([slots[i].index for i in rows], bucket)
        batch = torch.as_tensor(batch, device=self.device)
        lengths_dev = torch.as_tensor(lengths, device=self.device)
        sub = self.pool.gather(idx)
        acts, q, sub = self._prefill(params, sub, batch, lengths_dev,
                                     self._next_step())
        self.pool.scatter(idx, sub)
        acts, q = self._answer(acts, q)
        for j, i in enumerate(rows):
            slot = slots[i]
            slot.pos = int(positions[i])
            slot.cache_pos = int(lengths[j]) - 1
            actions[i] = acts[j]
            q_values[i] = q[j]
        self._stats["prefill_batches"] += 1
        self._stats["prefill_rows"] += g
        if self._m_prefill_ms:
            self._m_prefill_ms.observe((time.monotonic() - t0) * 1000.0)

    def _run_decode(self, params, rows, slots, windows, positions, actions,
                    q_values):
        t0 = time.monotonic() if self._m_decode_ms else 0.0
        g = len(rows)
        bucket = _bucket(g)
        w = self.window
        obs = np.zeros((bucket,) + windows.shape[2:], np.float32)
        pos = np.zeros((bucket,), np.int64)
        for j, i in enumerate(rows):
            # newest frame of a left-aligned window
            obs[j] = windows[i, min(int(positions[i]), w - 1)]
            pos[j] = slots[i].cache_pos + 1
        # every upload before the first kernel, while the stream is idle
        idx = self._pad([slots[i].index for i in rows], bucket)
        obs = torch.as_tensor(obs, device=self.device)
        pos = torch.as_tensor(pos, device=self.device)
        sub = self.pool.gather(idx)
        acts, q, sub = self._decode(params, sub, obs, pos, self._next_step())
        self.pool.scatter(idx, sub)
        acts, q = self._answer(acts, q)
        for j, i in enumerate(rows):
            slot = slots[i]
            slot.pos = int(positions[i])
            slot.cache_pos += 1
            actions[i] = acts[j]
            q_values[i] = q[j]
        self._stats["decode_batches"] += 1
        self._stats["decode_rows"] += g
        if self._m_decode_ms:
            self._m_decode_ms.observe((time.monotonic() - t0) * 1000.0)

    # ------------------------------------------------------------- lifecycle
    def release(self, key):
        self.pool.release(key)

    def release_client(self, client_id):
        self.pool.release_prefix(client_id)

    def stats(self) -> Dict[str, int]:
        s = dict(self._stats)
        s.update({f"pool_{k}": v for k, v in self.pool.stats.items()})
        s["pool_held_slots"] = self.pool.held()
        s["pool_utilization"] = self.pool.held() / max(self.pool.num_slots, 1)
        s["prefill_decode_ratio"] = (s["prefill_rows"]
                                     / max(s["decode_rows"], 1))
        return s
