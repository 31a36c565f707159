"""R2D3 (§3.6): R2D2 + expert demonstrations.

The recurrent learner's batches interleave agent-replay sequences with a
fixed table of demonstration sequences at a configurable ratio (Gulcehre et
al., 2020 — 'Making efficient use of demonstrations').
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.agents import r2d2 as r2d2_lib
from repro_torch.agents.dqfd import (agent_priorities_only, make_demo_table,
                                     mixed_iterator)
from repro_torch.core.types import EnvironmentSpec


@dataclasses.dataclass
class R2D3Config(r2d2_lib.R2D2Config):
    demo_ratio: float = 0.25


class R2D3Builder(r2d2_lib.R2D2Builder):
    """R2D2 builder whose dataset mixes in demonstration sequences.

    Inherits the ``AgentBuilder`` contract (and its ``BuilderOptions``)
    from ``R2D2Builder``; only the dataset and the priority-update filter
    differ.
    """

    def __init__(self, spec: EnvironmentSpec, demo_sequences,
                 cfg: R2D3Config = None, seed: int = 0, device="cuda"):
        super().__init__(spec, cfg or R2D3Config(), seed, device=device)
        self.demos = demo_sequences

    def make_demo_table(self):
        return make_demo_table("demo_seqs", self.demos)

    def make_dataset(self, table):
        return mixed_iterator(table, self.make_demo_table(),
                              self.cfg.batch_size, self.cfg.demo_ratio)

    def make_learner(self, iterator, priority_update_cb=None):
        return r2d2_lib.make_learner(
            self.spec, self.cfg, iterator,
            torch.Generator().manual_seed(self.seed),
            priority_update_cb=agent_priorities_only(priority_update_cb),
            device=self.device)
