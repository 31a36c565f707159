"""Behaviour Cloning (§3.7): the offline baseline — supervised learning of
the action mapping from a fixed dataset of transitions.

The learner runs on ``TorchLearner`` (one host copy a step, its only sync
with the device).  The eval policy takes a leading batch axis, like every
port policy: greedy ``argmax`` actions as int32, or ``tanh`` of the
network's output for continuous actions.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import optim, tree
from repro_torch.agents.common import (LearnerState, TorchLearner,  # noqa: F401
                                       state_from_jax)
from repro_torch.builders import AgentBuilder, BuilderOptions
from repro_torch.core.actors import FeedForwardActor
from repro_torch.core.types import EnvironmentSpec
from repro_torch.networks.mlp import flatten_obs, mlp_apply, mlp_init


@dataclasses.dataclass
class BCConfig:
    hidden: int = 64
    learning_rate: float = 1e-3
    batch_size: int = 64
    continuous: bool = False


def make_network(spec: EnvironmentSpec, cfg: BCConfig, device="cuda"):
    obs_dim = int(np.prod(spec.observations.shape)) or 1
    if cfg.continuous:
        out = int(np.prod(spec.actions.shape)) or 1
    else:
        out = spec.actions.num_values

    def init(generator: torch.Generator):
        return mlp_init(generator, (obs_dim, cfg.hidden, cfg.hidden, out),
                        device)

    def apply(params, obs):
        return mlp_apply(params, obs)

    return init, apply, obs_dim, out


def make_learner(spec: EnvironmentSpec, cfg: BCConfig, iterator: Iterator,
                 generator: torch.Generator, device="cuda") -> TorchLearner:
    init, apply, _, _ = make_network(spec, cfg, device)
    opt = optim.adam(cfg.learning_rate)
    params = init(generator)
    state = LearnerState(params, (), opt.init(params),
                         torch.zeros((), dtype=torch.int32, device=device))

    def loss_fn(params, t):
        obs = flatten_obs(t.observation, spec.observations.shape)
        pred = apply(params, obs)
        if cfg.continuous:
            a = t.action.reshape(obs.shape[0], -1).float()
            return torch.mean(torch.square(torch.tanh(pred) - a))
        logp = torch.log_softmax(pred, dim=-1)
        a = t.action.long()
        return -torch.mean(torch.gather(logp, -1, a[:, None]))

    def update(state: LearnerState, sample):
        leaves, treedef = tree.flatten(state.params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(tree.unflatten(treedef, leaves), sample.data)
        grads = tree.unflatten(treedef, torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            params = optim.apply_updates(state.params, updates)
        return (LearnerState(params, (), opt_state, state.steps + 1),
                {"loss": loss.detach()}, None)

    return TorchLearner(state, update, iterator, device=device)


def make_eval_policy(spec: EnvironmentSpec, cfg: BCConfig):
    """``policy(params, generator, obs (N, ...))``: greedy actions (N,)
    int32, or ``tanh`` of the output (N, action_dim); draws nothing."""
    _, apply, _, _ = make_network(spec, cfg)

    def policy(params, generator, obs):
        out = apply(params, flatten_obs(obs, spec.observations.shape))
        if cfg.continuous:
            return torch.tanh(out)
        return torch.argmax(out, dim=-1).to(torch.int32)

    return policy


class BCBuilder(AgentBuilder):
    """Offline builder (§2.6): learns from a fixed transition dataset.

    There is no insertion path — ``make_replay`` returns a table pre-loaded
    with the dataset and ``make_adder`` returns None.  Actors built from it
    are pure evaluators of the cloned policy.
    """

    def __init__(self, spec: EnvironmentSpec, dataset, cfg: BCConfig = None,
                 seed: int = 0, device="cuda"):
        cfg = cfg or BCConfig()
        super().__init__(BuilderOptions(
            variable_update_period=1,
            min_observations=0,
            observations_per_step=1.0,
            batch_size=cfg.batch_size,
            offline=True), device=device)
        self.spec = spec
        self.cfg = cfg
        self.seed = seed
        self.dataset = list(dataset)
        if not self.dataset:
            raise ValueError("BCBuilder needs a non-empty dataset")

    def make_replay(self):
        from repro_torch.replay import MinSize, Table, Uniform
        table = Table("dataset", len(self.dataset), Uniform(self.seed),
                      MinSize(1))
        for item in self.dataset:
            table.insert(item)
        return table

    def make_adder(self, table):
        return None              # offline: nothing writes to the dataset

    def make_dataset(self, table):
        from repro_torch.replay import as_iterator
        return as_iterator(table, self.cfg.batch_size)

    def make_learner(self, iterator, priority_update_cb=None):
        return make_learner(self.spec, self.cfg, iterator,
                            torch.Generator().manual_seed(self.seed),
                            device=self.device)

    def make_policy(self, evaluation: bool = False):
        return make_eval_policy(self.spec, self.cfg)

    def make_actor(self, policy, variable_client, adder, seed: int = 0):
        return FeedForwardActor(policy, variable_client, adder, rng_seed=seed,
                                device=self.device)
