"""Sequence and episode adders (R2D2/IMPALA-family, §3.2).

``SequenceAdder`` writes fixed-length sequences with configurable stride
(overlapping when stride < length, R2D2-style with burn-in prefix included in
the stored sequence; strided/non-overlapping for IMPALA queues).  Recurrent
core state at the start of each stored sequence can be attached via
``extras`` so learners can reconstruct state ("stale state" + burn-in, as the
paper describes).

``EpisodeAdder`` writes whole episodes (MCTS / demonstration ingestion).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import tree
from repro_torch.adders.base import Adder
from repro_torch.core.types import TimeStep
from repro_torch.replay.table import Table


def _seq_item(steps: List[Dict[str, Any]], pad_to: Optional[int] = None):
    """Stack a list of per-step dicts into arrays; zero-pad to pad_to."""
    out = tree.stack(steps)
    if pad_to is not None and len(steps) < pad_to:
        pad = pad_to - len(steps)
        out = tree.map(
            lambda x: np.concatenate(
                [x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0), out)
    mask = np.zeros(pad_to or len(steps), np.float32)
    mask[:len(steps)] = 1.0
    out["mask"] = mask
    return out


class SequenceAdder(Adder):
    supports_extras = True   # add_first(timestep, extras): recurrent state

    def __init__(self, table: Table, sequence_length: int, period: int,
                 priority: float = 1.0, pad_end: bool = True):
        if period <= 0 or sequence_length <= 0:
            raise ValueError("period and sequence_length must be positive")
        self.table = table
        self.length = sequence_length
        self.period = period
        self.default_priority = priority
        self.pad_end = pad_end
        self._steps: List[Dict[str, Any]] = []
        self._since_write = 0
        self._obs = None
        self._start_extras = None

    def reset(self):
        self._steps = []
        self._since_write = 0
        self._obs = None
        self._start_extras = None

    def add_first(self, timestep: TimeStep, extras: Any = ()):
        self.reset()
        self._obs = timestep.observation
        self._start_extras = extras

    def add(self, action, next_timestep: TimeStep, extras: Any = ()):
        if self._obs is None:
            raise RuntimeError("add() before add_first()")
        step = {
            "observation": np.asarray(self._obs),
            "action": np.asarray(action),
            "reward": np.float32(next_timestep.reward),
            "discount": np.float32(next_timestep.discount),
            "start_of_episode": np.bool_(len(self._steps) == 0),
        }
        if extras:
            step.update({k: np.asarray(v) for k, v in dict(extras).items()})
        self._steps.append(step)
        self._obs = next_timestep.observation
        self._since_write += 1

        if len(self._steps) == self.length:
            self._write()
            # keep overlap: drop `period` steps from the front
            self._steps = self._steps[self.period:]
            self._since_write = 0
        if next_timestep.last():
            if self._steps and self.pad_end:
                self._write(pad=True)
            self.reset()

    def _write(self, pad: bool = False):
        item = _seq_item(self._steps, pad_to=self.length if pad else None)
        self.table.insert(item, priority=self.default_priority)


class EpisodeAdder(Adder):
    def __init__(self, table: Table, max_episode_length: int = 10_000,
                 priority: float = 1.0):
        self.table = table
        self.max_len = max_episode_length
        self.default_priority = priority
        self._steps: List[Dict[str, Any]] = []
        self._obs = None

    def reset(self):
        self._steps = []
        self._obs = None

    def add_first(self, timestep: TimeStep):
        self.reset()
        self._obs = timestep.observation

    def add(self, action, next_timestep: TimeStep, extras: Any = ()):
        if self._obs is None:
            raise RuntimeError("add() before add_first()")
        self._steps.append({
            "observation": np.asarray(self._obs),
            "action": np.asarray(action),
            "reward": np.float32(next_timestep.reward),
            "discount": np.float32(next_timestep.discount),
        })
        self._obs = next_timestep.observation
        if len(self._steps) >= self.max_len or next_timestep.last():
            self.table.insert(_seq_item(self._steps),
                              priority=self.default_priority)
            self.reset()
            if not next_timestep.last():
                self._obs = next_timestep.observation
