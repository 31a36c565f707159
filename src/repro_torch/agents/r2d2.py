"""R2D2 (§3.2): recurrent replay distributed DQN.

Sequences (with stored initial LSTM state + burn-in prefix), double
Q-learning over fixed-length sequences, prioritized by a convex combination
of mean and max absolute TD errors, n-step bootstrap targets.

The learner runs on ``TorchLearner`` (one host copy a step, its only sync
with the device).  As in the JAX package, the learner starts each
sequence's unroll from a zero state and warms it over the burn-in prefix,
without gradient, for the online and the target params alike
(``repro/agents/r2d2.py:78-88``); the state the actor stores at a
sequence's start reaches the adder as numpy extras.  The behaviour policy
takes a leading batch axis and draws its random action and its explore
coin as two independent draws from the actor's ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import optim, tree
from repro_torch.agents.common import (LearnerState, TorchLearner,
                                       fresh_copy, importance_weights)
from repro_torch.builders import AgentBuilder, BuilderOptions
from repro_torch.core.types import EnvironmentSpec
from repro_torch.networks.lstm import LSTMNetwork, LSTMState
from repro_torch.networks.mlp import flatten_obs
from repro_torch.replay.dataset import ReplaySample


@dataclasses.dataclass
class R2D2Config:
    hidden: int = 64
    lstm_size: int = 64
    learning_rate: float = 1e-3
    discount: float = 0.99
    sequence_length: int = 16
    period: int = 8                  # overlapping sequences
    burn_in: int = 4
    batch_size: int = 32
    target_update_period: int = 100
    epsilon: float = 0.1
    min_replay_size: int = 100
    max_replay_size: int = 50_000
    samples_per_insert: float = 4.0
    priority_eta: float = 0.9        # max/mean TD mixing
    importance_beta: float = 0.6


def make_network(spec: EnvironmentSpec, cfg: R2D2Config) -> LSTMNetwork:
    num_actions = spec.actions.num_values
    net = LSTMNetwork((cfg.hidden,), cfg.lstm_size, num_actions)
    net.in_dim = int(np.prod(spec.observations.shape)) or 1
    return net


def make_learner(spec: EnvironmentSpec, cfg: R2D2Config, iterator: Iterator,
                 generator: torch.Generator, priority_update_cb=None,
                 device="cuda") -> TorchLearner:
    net = make_network(spec, cfg)
    opt = optim.adam(cfg.learning_rate, clip=40.0)
    params = net.init(generator, net.in_dim, device)
    state = LearnerState(params, fresh_copy(params), opt.init(params),
                         torch.zeros((), dtype=torch.int32, device=device))

    def loss_fn(params, target_params, sample: ReplaySample):
        seq = sample.data
        obs = seq["observation"].float()                       # (B, T, ...)
        B, T = obs.shape[:2]
        obs_tm = obs.reshape(B, T, -1).transpose(0, 1)         # (T, B, feat)
        actions = seq["action"].long().transpose(0, 1)
        rewards = seq["reward"].float().transpose(0, 1)
        discounts = (seq["discount"].float() * cfg.discount).transpose(0, 1)
        mask = seq["mask"].float().transpose(0, 1)

        # stored initial state ("stale state"), burn-in re-warms it
        init_state = LSTMState(
            torch.zeros((B, cfg.lstm_size), device=obs.device),
            torch.zeros((B, cfg.lstm_size), device=obs.device))
        if cfg.burn_in > 0:
            burn = obs_tm[:cfg.burn_in]
            with torch.no_grad():
                _, warm = net.unroll(params, burn, init_state)
                _, warm_t = net.unroll(target_params, burn, init_state)
        else:
            warm = warm_t = init_state
        obs_l = obs_tm[cfg.burn_in:]
        act_l = actions[cfg.burn_in:]
        rew_l = rewards[cfg.burn_in:]
        disc_l = discounts[cfg.burn_in:]
        mask_l = mask[cfg.burn_in:]

        q, _ = net.unroll(params, obs_l, warm)                 # (L, B, A)
        with torch.no_grad():          # the target: a stop-gradient
            q_target, _ = net.unroll(target_params, obs_l, warm_t)
            # double Q with 1-step-within-sequence targets
            a_star = torch.argmax(q[1:], dim=-1)
            next_v = torch.gather(q_target[1:], -1, a_star[..., None])[..., 0]
            y = rew_l[:-1] + disc_l[:-1] * next_v
        q_taken = torch.gather(q[:-1], -1, act_l[:-1][..., None])[..., 0]
        td = (y - q_taken) * mask_l[:-1]

        w = importance_weights(sample.info.probabilities,
                               cfg.importance_beta)
        loss = 0.5 * torch.sum(w[None, :] * torch.square(td)) / torch.clamp(
            torch.sum(mask_l[:-1]), min=1.0)
        abs_td = torch.abs(td.detach())
        prio = cfg.priority_eta * torch.amax(abs_td, dim=0) + \
            (1 - cfg.priority_eta) * torch.mean(abs_td, dim=0)
        return loss, prio

    def update(state: LearnerState, sample: ReplaySample):
        leaves, treedef = tree.flatten(state.params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss, prio = loss_fn(tree.unflatten(treedef, leaves),
                             state.target_params, sample)
        grads = tree.unflatten(treedef, torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            params = optim.apply_updates(state.params, updates)
            steps = state.steps + 1
            target = optim.periodic_update(params, state.target_params,
                                           steps, cfg.target_update_period)
        return (LearnerState(params, target, opt_state, steps),
                {"loss": loss.detach()}, prio)

    return TorchLearner(state, update, iterator,
                        priority_update_cb=priority_update_cb, device=device)


def make_behavior_policy(spec: EnvironmentSpec, cfg: R2D2Config,
                         epsilon=None):
    """``policy(params, generator, obs (N, ...), lstm_state (N rows)) ->
    (actions (N,) int32, lstm_state)``: epsilon-greedy over the Q values,
    the greedy action by ``argmax`` (the first maximum, as
    ``jnp.argmax``)."""
    net = make_network(spec, cfg)
    num_actions = spec.actions.num_values
    eps = cfg.epsilon if epsilon is None else epsilon

    def policy(params, generator, obs, lstm_state):
        obs = flatten_obs(obs, spec.observations.shape)
        q, new_state = net.apply(params, obs, lstm_state)
        greedy = torch.argmax(q, dim=-1)
        rows = (q.shape[0],)
        rand = torch.randint(0, num_actions, rows, generator=generator,
                             device=q.device)
        explore = torch.rand(rows, generator=generator, device=q.device) < eps
        return torch.where(explore, rand, greedy).to(torch.int32), new_state

    return policy


class R2D2Builder(AgentBuilder):
    def __init__(self, spec: EnvironmentSpec, cfg: R2D2Config = None,
                 seed: int = 0, device="cuda"):
        cfg = cfg or R2D2Config()
        super().__init__(BuilderOptions(
            variable_update_period=10,
            min_observations=cfg.min_replay_size,
            observations_per_step=max(float(cfg.period), 1.0),
            batch_size=cfg.batch_size), device=device)
        self.spec = spec
        self.cfg = cfg
        self.seed = seed

    def make_replay(self):
        from repro_torch import replay as r
        cfg = self.cfg
        if cfg.samples_per_insert > 0:
            limiter = r.SampleToInsertRatio(
                cfg.samples_per_insert, cfg.min_replay_size // cfg.period + 1,
                error_buffer=max(2 * cfg.samples_per_insert * cfg.batch_size, 100))
        else:
            limiter = r.MinSize(max(cfg.min_replay_size // cfg.period, 1))
        return r.Table("replay", cfg.max_replay_size, r.Prioritized(), limiter)

    def make_adder(self, table):
        from repro_torch.adders.sequence import SequenceAdder
        return SequenceAdder(table, self.cfg.sequence_length,
                             period=self.cfg.period, priority=100.0)

    def make_dataset(self, table):
        from repro_torch.replay import as_iterator
        return as_iterator(table, self.cfg.batch_size)

    def make_learner(self, iterator, priority_update_cb=None):
        return make_learner(self.spec, self.cfg, iterator,
                            torch.Generator().manual_seed(self.seed),
                            priority_update_cb=priority_update_cb,
                            device=self.device)

    def make_policy(self, evaluation: bool = False):
        return make_behavior_policy(self.spec, self.cfg,
                                    epsilon=0.0 if evaluation else None)

    def _initial_state_fn(self):
        net = make_network(self.spec, self.cfg)
        return lambda: net.initial_state(1, device=self.device)

    def make_actor(self, policy, variable_client, adder, seed: int = 0):
        from repro_torch.core import RecurrentActor
        return RecurrentActor(policy, self._initial_state_fn(),
                              variable_client, adder, rng_seed=seed,
                              device=self.device)

    def make_batched_actor(self, policy, variable_client, adders,
                           seed: int = 0):
        from repro_torch.core import BatchedRecurrentActor
        return BatchedRecurrentActor(policy, self._initial_state_fn(),
                                     variable_client, adders, rng_seed=seed,
                                     device=self.device)
