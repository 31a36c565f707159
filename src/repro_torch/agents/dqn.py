"""DQN (§3.2): double Q-learning, n-step targets (via the adder), dueling
heads, prioritized replay with importance weighting — the paper's enhanced
("in the spirit of Rainbow") implementation.

The learner runs on ``TorchLearner``: one step moves the loss, the step
counter and the ``|td|`` priorities to the host in one copy, its only sync
with the device.  The behaviour policy takes a leading batch axis, like
every port policy, and draws its random action and its explore coin as two
independent draws from the actor's ``torch.Generator`` (the JAX package
draws both from one key, ``repro/agents/dqn.py:118-119``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import optim, tree
from repro_torch.agents.common import (LearnerState, TorchLearner,
                                       fresh_copy, importance_weights)
from repro_torch.builders import AgentBuilder, BuilderOptions
from repro_torch.core.actors import FeedForwardActor
from repro_torch.core.types import EnvironmentSpec
from repro_torch.networks import heads as heads_lib
from repro_torch.networks.mlp import flatten_obs, mlp_apply, mlp_init
from repro_torch.replay.dataset import ReplaySample


@dataclasses.dataclass
class DQNConfig:
    hidden: int = 64
    dueling: bool = True
    learning_rate: float = 1e-3
    discount: float = 0.99
    n_step: int = 3
    target_update_period: int = 100
    epsilon: float = 0.1
    batch_size: int = 64
    min_replay_size: int = 200
    max_replay_size: int = 100_000
    samples_per_insert: float = 4.0
    importance_beta: float = 0.6
    prioritized: bool = True


def make_q_network(spec: EnvironmentSpec, cfg: DQNConfig, device="cuda"):
    num_actions = spec.actions.num_values
    in_dim = int(np.prod(spec.observations.shape)) or 1

    def init(generator: torch.Generator):
        p = {"torso": mlp_init(generator, (in_dim, cfg.hidden, cfg.hidden),
                               device)}
        if cfg.dueling:
            p["head"] = heads_lib.dueling_init(generator, cfg.hidden,
                                               cfg.hidden, num_actions, device)
        else:
            p["head"] = {"q": mlp_init(generator, (cfg.hidden, num_actions),
                                       device)}
        return p

    def apply(params, obs):
        h = mlp_apply(params["torso"], obs, activate_final=True)
        if cfg.dueling:
            return heads_lib.dueling_apply(params["head"], h)
        return mlp_apply(params["head"]["q"], h)

    return init, apply, in_dim, num_actions


def make_learner(spec: EnvironmentSpec, cfg: DQNConfig, iterator: Iterator,
                 generator: torch.Generator, priority_update_cb=None,
                 device="cuda") -> TorchLearner:
    init, apply, _, _ = make_q_network(spec, cfg, device)
    opt = optim.adam(cfg.learning_rate, clip=40.0)
    params = init(generator)
    state = LearnerState(params, fresh_copy(params), opt.init(params),
                         torch.zeros((), dtype=torch.int32, device=device))

    def loss_fn(params, target_params, sample: ReplaySample):
        t = sample.data
        obs = flatten_obs(t.observation, spec.observations.shape)
        next_obs = flatten_obs(t.next_observation, spec.observations.shape)
        q = apply(params, obs)
        with torch.no_grad():          # the target: a stop-gradient
            a_star = torch.argmax(apply(params, next_obs), dim=-1)
            next_v = torch.gather(apply(target_params, next_obs), -1,
                                  a_star[:, None])[:, 0]
            y = t.reward + t.discount * next_v
        q_taken = torch.gather(q, -1, t.action[:, None].long())[:, 0]
        td = y - q_taken
        if cfg.prioritized:
            w = importance_weights(sample.info.probabilities,
                                   cfg.importance_beta)
        else:
            w = torch.ones_like(td)
        loss = 0.5 * torch.mean(w * torch.square(td))
        return loss, td

    def update(state: LearnerState, sample: ReplaySample):
        leaves, treedef = tree.flatten(state.params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss, td = loss_fn(tree.unflatten(treedef, leaves),
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
                {"loss": loss.detach()}, torch.abs(td.detach()))

    return TorchLearner(state, update, iterator,
                        priority_update_cb=priority_update_cb
                        if cfg.prioritized else None, device=device)


def make_behavior_policy(spec: EnvironmentSpec, cfg: DQNConfig,
                         epsilon: Optional[float] = None):
    """``policy(params, generator, obs (N, ...)) -> actions (N,) int32``:
    epsilon-greedy over the Q values, the greedy action by ``argmax``
    (the first maximum, as ``jnp.argmax``)."""
    _, apply, _, num_actions = make_q_network(spec, cfg)
    eps = cfg.epsilon if epsilon is None else epsilon

    def policy(params, generator, obs):
        q = apply(params, flatten_obs(obs, spec.observations.shape))
        greedy = torch.argmax(q, dim=-1)
        rows = (q.shape[0],)
        rand = torch.randint(0, num_actions, rows, generator=generator,
                             device=q.device)
        explore = torch.rand(rows, generator=generator, device=q.device) < eps
        return torch.where(explore, rand, greedy).to(torch.int32)

    return policy


def make_eval_policy(spec: EnvironmentSpec, cfg: DQNConfig):
    return make_behavior_policy(spec, cfg, epsilon=0.0)


class DQNBuilder(AgentBuilder):
    """Typed builder (repro_torch.builders.AgentBuilder) for DQN."""

    def __init__(self, spec: EnvironmentSpec, cfg: DQNConfig = None,
                 seed: int = 0, spi_tolerance: float = None, device="cuda"):
        cfg = cfg or DQNConfig()
        super().__init__(BuilderOptions(
            variable_update_period=10,
            min_observations=cfg.min_replay_size,
            observations_per_step=max(
                cfg.batch_size / cfg.samples_per_insert, 1.0)
            if cfg.samples_per_insert > 0 else 1.0,
            batch_size=cfg.batch_size), device=device)
        self.spec = spec
        self.cfg = cfg
        self.seed = seed
        self.spi_tolerance = spi_tolerance

    def make_replay(self):
        from repro_torch import replay as r
        cfg = self.cfg
        tol = self.spi_tolerance
        if cfg.samples_per_insert > 0:
            limiter = r.SampleToInsertRatio(
                cfg.samples_per_insert, cfg.min_replay_size,
                error_buffer=tol if tol is not None
                else max(cfg.samples_per_insert * 2 * cfg.batch_size, 100.0))
        else:
            limiter = r.MinSize(cfg.min_replay_size)
        selector = r.Prioritized() if cfg.prioritized else r.Uniform(self.seed)
        return r.Table("replay", cfg.max_replay_size, selector, limiter)

    def make_adder(self, table):
        from repro_torch.adders import NStepTransitionAdder
        return NStepTransitionAdder(table, self.cfg.n_step, self.cfg.discount,
                                    priority=100.0)

    def make_dataset(self, table):
        from repro_torch.replay import as_iterator
        return as_iterator(table, self.cfg.batch_size)

    def make_learner(self, iterator, priority_update_cb=None):
        return make_learner(self.spec, self.cfg, iterator,
                            torch.Generator().manual_seed(self.seed),
                            priority_update_cb=priority_update_cb,
                            device=self.device)

    def make_policy(self, evaluation: bool = False):
        if evaluation:
            return make_eval_policy(self.spec, self.cfg)
        return make_behavior_policy(self.spec, self.cfg)

    def make_actor(self, policy, variable_client, adder, seed: int = 0):
        return FeedForwardActor(policy, variable_client, adder, rng_seed=seed,
                                device=self.device)
