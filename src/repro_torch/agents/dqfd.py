"""DQfD / R2D3 (§3.6): RL with Expert Demonstrations.

Learner batches are a fixed-ratio interleave of agent replay and an expert
demonstration table (both prioritized), applied to the DQN learner (DQfD) or
the R2D2 learner (R2D3).  ``mixed_iterator`` samples the demo table, then
the agent table, each through its own selector, in the JAX package's order,
so the two packages give the same batches from the same tables.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np
import torch

from repro_torch import tree
from repro_torch.agents import dqn as dqn_lib
from repro_torch.core.types import EnvironmentSpec, Transition
from repro_torch.replay.dataset import ReplaySample, SampleInfo
from repro_torch.replay.table import Table


@dataclasses.dataclass
class DQfDConfig(dqn_lib.DQNConfig):
    demo_ratio: float = 0.25           # fraction of each batch from demos


def mixed_iterator(agent_table: Table, demo_table: Table, batch_size: int,
                   demo_ratio: float) -> Iterator[ReplaySample]:
    """Interleave samples: ceil(ratio*B) demo items + rest agent items."""
    n_demo = max(int(round(demo_ratio * batch_size)), 1)
    n_agent = batch_size - n_demo
    while True:
        demo = demo_table.sample(n_demo)
        agent = agent_table.sample(n_agent)
        items = [it.data for it, _ in demo] + [it.data for it, _ in agent]
        keys = np.array([it.key for it, _ in demo] +
                        [it.key for it, _ in agent], np.int64)
        probs = np.array([p for _, p in demo] + [p for _, p in agent])
        data = tree.stack(items)
        # priorities are only updated on the agent table; mark demo keys -1
        keys[:n_demo] = -1
        yield ReplaySample(SampleInfo(keys, probs), data)


def agent_priorities_only(priority_update_cb):
    """The priority callback with the demo rows (key -1) left out."""
    def cb(keys, priorities):
        if priority_update_cb is None:
            return
        m = keys >= 0
        priority_update_cb(keys[m], priorities[m])
    return cb


def generate_deep_sea_demos(env, num_demos: int, success_rate: float = 1.0,
                            n_step: int = 1, discount: float = 1.0,
                            seed: int = 0) -> List[Transition]:
    """Optimal-policy demonstrations for DeepSea (§4.8: 'generated using the
    optimal policy, which has knowledge of the action mapping')."""
    from repro_torch.adders.transition import NStepTransitionAdder
    from repro_torch.replay import MinSize, Uniform

    tmp = Table("demos_tmp", 1_000_000, Uniform(seed), MinSize(1))
    adder = NStepTransitionAdder(tmp, n_step, discount)
    rng = np.random.RandomState(seed)
    for ep in range(num_demos):
        succeed = rng.rand() < success_rate
        ts = env.reset()
        adder.add_first(ts)
        while not ts.last():
            a = env.optimal_action() if succeed else int(rng.randint(2))
            ts = env.step(a)
            adder.add(a, ts)
    items = [tmp._items[k].data for k in tmp._order]
    return items


def generate_sequence_demos(env, optimal_action_fn, num_demos: int,
                            sequence_length: int, period: int,
                            seed: int = 0):
    """Demonstration sequences for R2D3 (recurrent learners)."""
    from repro_torch.adders.sequence import SequenceAdder
    from repro_torch.replay import MinSize, Uniform

    tmp = Table("demo_seqs", 1_000_000, Uniform(seed), MinSize(1))
    adder = SequenceAdder(tmp, sequence_length, period)
    for _ in range(num_demos):
        ts = env.reset()
        adder.add_first(ts)
        while not ts.last():
            a = optimal_action_fn(env)
            ts = env.step(a)
            adder.add(a, ts)
    return [tmp._items[k].data for k in tmp._order]


def make_demo_table(name: str, demos) -> Table:
    """A prioritized table holding every demonstration at priority 1."""
    from repro_torch import replay as r
    table = r.Table(name, max(len(demos), 1), r.Prioritized(), r.MinSize(1))
    for item in demos:
        table.insert(item, priority=1.0)
    return table


class DQfDBuilder(dqn_lib.DQNBuilder):
    """DQN builder whose dataset mixes in a demonstration table.

    Inherits the ``AgentBuilder`` contract (and its ``BuilderOptions``,
    computed from the config) from ``DQNBuilder``; only the dataset and the
    priority-update filter differ.
    """

    def __init__(self, spec: EnvironmentSpec, demos, cfg: DQfDConfig = None,
                 seed: int = 0, device="cuda"):
        super().__init__(spec, cfg or DQfDConfig(), seed, device=device)
        self.demos = demos

    def make_demo_table(self):
        return make_demo_table("demos", self.demos)

    def make_dataset(self, table):
        return mixed_iterator(table, self.make_demo_table(),
                              self.cfg.batch_size, self.cfg.demo_ratio)

    def make_learner(self, iterator, priority_update_cb=None):
        # filter demo keys (-1) out of priority updates
        return dqn_lib.make_learner(
            self.spec, self.cfg, iterator,
            torch.Generator().manual_seed(self.seed),
            priority_update_cb=agent_priorities_only(priority_update_cb),
            device=self.device)
