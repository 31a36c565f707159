"""Continuous-control actor-critic agents (§3.4): DDPG, D4PG, MPO, DMPO.

All four share: n-step transition replay (uniform sampling — the paper found
prioritization gives minimal benefit here), Gaussian exploration noise,
target networks.  They differ in the policy loss (deterministic PG vs MPO's
EM) and the critic (expected vs C51 distributional).

The learner runs on ``TorchLearner`` (one host copy a step, its only sync
with the device), and computes what the JAX package computes: one gradient
of critic loss plus policy loss over every param, stepped by the policy's
Adam alone (``repro/agents/continuous.py:195-202``).  The critic's atoms
are made once, on the learner's device.  MPO and DMPO draw normals in the
learner (the target policy's noise in the critic loss, then the E-step's
samples); the draws come from a ``torch.Generator`` on the learner's
device, seeded with ``LEARNER_SEED * STEP_MOD + step`` from a step counter
kept on the host (the reference folds the step into ``key(17)``), and all of
them go through ``learner_normal``.  The behaviour policy takes a leading
batch axis and draws its exploration noise from the actor's generator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import optim, tree
from repro_torch.agents.common import (ClockedLearner,  # noqa: F401
                                       LearnerState, StepClock, TorchLearner,
                                       fresh_copy, state_from_jax)
from repro_torch.builders import AgentBuilder, BuilderOptions
from repro_torch.core.actors import STEP_MOD, FeedForwardActor
from repro_torch.core.types import EnvironmentSpec
from repro_torch.networks.heads import l2_project
from repro_torch.networks.mlp import flatten_obs, mlp_apply, mlp_init
from repro_torch.replay.dataset import ReplaySample

LEARNER_SEED = 17


@dataclasses.dataclass
class ContinuousConfig:
    algo: str = "d4pg"            # ddpg | d4pg | mpo | dmpo
    hidden: int = 256
    policy_lr: float = 1e-3
    critic_lr: float = 1e-3
    discount: float = 0.99
    n_step: int = 5
    batch_size: int = 256
    min_replay_size: int = 1000
    max_replay_size: int = 1_000_000
    samples_per_insert: float = 32.0
    sigma: float = 0.2            # exploration noise
    target_update_period: int = 100
    # distributional critic
    num_atoms: int = 51
    vmin: float = 0.0
    vmax: float = 1000.0
    # mpo duals
    mpo_epsilon: float = 0.1
    mpo_eps_mean: float = 1e-2
    mpo_eps_std: float = 1e-5
    mpo_samples: int = 16


def _distributional(cfg):
    return cfg.algo in ("d4pg", "dmpo")


def _mpo_family(cfg):
    return cfg.algo in ("mpo", "dmpo")


def learner_normal(generator: torch.Generator, shape) -> torch.Tensor:
    """Every normal draw of the MPO-family learner, in the order the JAX
    package splits its key: the target policy's noise (B, A) in the critic
    loss, then the E-step's samples (S, B, A).  One function, so that a test
    can hand the learner the reference's draws."""
    return torch.randn(shape, generator=generator, device=generator.device)


def make_networks(spec: EnvironmentSpec, cfg: ContinuousConfig,
                  device="cuda"):
    obs_dim = int(np.prod(spec.observations.shape)) or 1
    act_dim = int(np.prod(spec.actions.shape)) or 1
    critic_out = cfg.num_atoms if _distributional(cfg) else 1
    policy_out = 2 * act_dim if _mpo_family(cfg) else act_dim

    def init(generator: torch.Generator):
        def zero():
            return torch.zeros((), dtype=torch.float32, device=device)

        return {
            "policy": mlp_init(generator, (obs_dim, cfg.hidden, cfg.hidden,
                                           policy_out), device),
            "critic": mlp_init(generator, (obs_dim + act_dim, cfg.hidden,
                                           cfg.hidden, critic_out), device),
            "log_temp": zero(),                 # MPO duals
            "log_alpha_mean": zero(),
            "log_alpha_std": zero(),
        }

    def policy_dist(params, obs):
        out = mlp_apply(params["policy"], obs)
        if _mpo_family(cfg):
            mean, raw = torch.chunk(out, 2, dim=-1)
            return torch.tanh(mean), F.softplus(raw) + 1e-3
        return torch.tanh(out), None

    def critic(params, obs, act):
        h = torch.cat([obs, act], dim=-1)
        out = mlp_apply(params["critic"], h)
        if _distributional(cfg):
            return out                           # logits over atoms
        return out[..., 0]

    return init, policy_dist, critic, obs_dim, act_dim


# A continuous learner keeps its step on the host to seed its draws.
ContinuousLearner = ClockedLearner


def make_learner(spec: EnvironmentSpec, cfg: ContinuousConfig,
                 iterator: Iterator, generator: torch.Generator,
                 device="cuda") -> ContinuousLearner:
    init, policy_dist, critic, obs_dim, act_dim = make_networks(spec, cfg,
                                                                device)
    popt = optim.adam(cfg.policy_lr, clip=40.0)
    copt = optim.adam(cfg.critic_lr, clip=40.0)
    params = init(generator)
    opt_state = (popt.init(params), copt.init(params))
    state = LearnerState(params, fresh_copy(params), opt_state,
                         torch.zeros((), dtype=torch.int32, device=device))
    atoms = torch.linspace(cfg.vmin, cfg.vmax, cfg.num_atoms, device=device)
    obs_shape = spec.observations.shape
    clock = StepClock()
    draws = (torch.Generator(device=device) if _mpo_family(cfg) else None)

    def q_mean(params, obs, act):
        out = critic(params, obs, act)
        if _distributional(cfg):
            return torch.sum(torch.softmax(out, -1) * atoms, -1)
        return out

    def critic_loss(params, target_params, t):
        obs = flatten_obs(t.observation, obs_shape)
        nobs = flatten_obs(t.next_observation, obs_shape)
        act = t.action.reshape(obs.shape[0], -1).float()
        with torch.no_grad():          # the target: a stop-gradient
            nmean, nstd = policy_dist(target_params, nobs)
            if nstd is not None:
                na = nmean + nstd * learner_normal(draws, nmean.shape)
                na = torch.clamp(na, -1, 1)
            else:
                na = nmean
            if _distributional(cfg):
                target_p = torch.softmax(critic(target_params, nobs, na), -1)
                z_target = (t.reward[:, None]
                            + t.discount[:, None] * atoms[None, :])
                proj = l2_project(z_target, target_p, atoms)
            else:
                y = t.reward + t.discount * critic(target_params, nobs, na)
        if _distributional(cfg):
            logp = torch.log_softmax(critic(params, obs, act), -1)
            return -torch.mean(torch.sum(proj * logp, -1))
        q = critic(params, obs, act)
        return 0.5 * torch.mean(torch.square(y - q))

    def dpg_policy_loss(params, t):
        # differentiates q_mean(params, ...): the gradient reaches the
        # critic's weights too, as in the JAX package
        obs = flatten_obs(t.observation, obs_shape)
        mean, _ = policy_dist(params, obs)
        return -torch.mean(q_mean(params, obs, mean))

    def mpo_policy_loss(params, target_params, t):
        """Simplified MPO E/M steps with temperature + KL-alpha duals."""
        obs = flatten_obs(t.observation, obs_shape)
        B = obs.shape[0]
        S = cfg.mpo_samples
        with torch.no_grad():
            tmean, tstd = policy_dist(target_params, obs)
            samples = tmean[None] + tstd[None] * learner_normal(
                draws, (S, B, act_dim))                   # (S, B, A)
            samples = torch.clamp(samples, -1, 1)
            q = q_mean(target_params, obs[None].expand(S, B, obs_dim),
                       samples)                           # (S, B)
        temp = torch.exp(params["log_temp"]) + 1e-8
        # E-step: weights + temperature dual loss
        w = torch.exp(torch.log_softmax(q / temp, dim=0)).detach()
        temp_loss = temp * (cfg.mpo_epsilon + torch.mean(
            torch.logsumexp(q / temp, dim=0) - math.log(S)))
        # M-step: weighted max-likelihood under the online policy
        mean, std = policy_dist(params, obs)
        logp = -0.5 * torch.sum(
            torch.square((samples - mean[None]) / std[None])
            + 2 * torch.log(std[None]), dim=-1)           # (S, B)
        ml_loss = -torch.mean(torch.sum(w * logp, dim=0))
        # decoupled KL regularization to the target policy
        kl_mean = torch.mean(0.5 * torch.sum(
            torch.square((mean - tmean) / tstd), dim=-1))
        kl_std = torch.mean(torch.sum(
            torch.log(std / tstd) + (torch.square(tstd)
                                     / (2 * torch.square(std))) - 0.5,
            dim=-1))
        a_mean = torch.exp(params["log_alpha_mean"])
        a_std = torch.exp(params["log_alpha_std"])
        alpha_mean_loss = a_mean * (cfg.mpo_eps_mean - kl_mean.detach())
        alpha_std_loss = a_std * (cfg.mpo_eps_std - kl_std.detach())
        policy_loss = ml_loss + a_mean.detach() * kl_mean \
            + a_std.detach() * kl_std
        return policy_loss + temp_loss + alpha_mean_loss + alpha_std_loss

    def update(state: LearnerState, sample: ReplaySample):
        t = sample.data
        if draws is not None:
            draws.manual_seed(LEARNER_SEED * STEP_MOD + clock.steps)
        leaves, treedef = tree.flatten(state.params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        params = tree.unflatten(treedef, leaves)
        cl = critic_loss(params, state.target_params, t)
        if _mpo_family(cfg):
            pl = mpo_policy_loss(params, state.target_params, t)
        else:
            pl = dpg_policy_loss(params, t)
        grads = torch.autograd.grad(cl + pl, leaves, allow_unused=True)
        # DDPG and D4PG leave the MPO duals out of the loss: zero grads
        grads = tree.unflatten(treedef, [
            torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, leaves)])
        p_opt, c_opt = state.opt_state
        with torch.no_grad():
            pupd, p_opt = popt.update(grads, p_opt, state.params)
            params = optim.apply_updates(state.params, pupd)
            steps = state.steps + 1
            target = optim.periodic_update(params, state.target_params,
                                           steps, cfg.target_update_period)
        clock.steps = (clock.steps + 1) % STEP_MOD
        cl, pl = cl.detach(), pl.detach()
        return (LearnerState(params, target, (p_opt, c_opt), steps),
                {"critic_loss": cl, "policy_loss": pl, "loss": cl + pl}, None)

    return ContinuousLearner(state, update, iterator, clock, device=device)


def make_behavior_policy(spec: EnvironmentSpec, cfg: ContinuousConfig,
                         evaluation: bool = False):
    """``policy(params, generator, obs (N, ...)) -> actions (N, A)``: the
    policy's mean plus Gaussian noise (``sigma``, or the policy's own scale
    for MPO and DMPO; none at ``evaluation``), clipped to [-1, 1]."""
    _, policy_dist, _, _, _ = make_networks(spec, cfg)

    def policy(params, generator, obs):
        mean, std = policy_dist(params,
                                flatten_obs(obs, spec.observations.shape))
        a = mean
        if not evaluation:
            noise = cfg.sigma if std is None else std
            a = a + noise * torch.randn(mean.shape, generator=generator,
                                        device=mean.device)
        return torch.clamp(a, -1.0, 1.0)

    return policy


class ContinuousBuilder(AgentBuilder):
    def __init__(self, spec: EnvironmentSpec, cfg: ContinuousConfig = None,
                 seed: int = 0, device="cuda"):
        cfg = cfg or ContinuousConfig()
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

    def make_replay(self):
        from repro_torch import replay as r
        cfg = self.cfg
        if cfg.samples_per_insert > 0:
            limiter = r.SampleToInsertRatio(
                cfg.samples_per_insert, cfg.min_replay_size,
                error_buffer=max(2 * cfg.samples_per_insert * cfg.batch_size,
                                 1000))
        else:
            limiter = r.MinSize(cfg.min_replay_size)
        return r.Table("replay", cfg.max_replay_size, r.Uniform(self.seed),
                       limiter)

    def make_adder(self, table):
        from repro_torch.adders import NStepTransitionAdder
        return NStepTransitionAdder(table, self.cfg.n_step, self.cfg.discount)

    def make_dataset(self, table):
        from repro_torch.replay import as_iterator
        return as_iterator(table, self.cfg.batch_size)

    def make_learner(self, iterator, priority_update_cb=None):
        return make_learner(self.spec, self.cfg, iterator,
                            torch.Generator().manual_seed(self.seed),
                            device=self.device)

    def make_policy(self, evaluation: bool = False):
        return make_behavior_policy(self.spec, self.cfg, evaluation)

    def make_actor(self, policy, variable_client, adder, seed: int = 0):
        return FeedForwardActor(policy, variable_client, adder, rng_seed=seed,
                                device=self.device)


def builder_for(algo: str, spec: EnvironmentSpec, seed: int = 0,
                device="cuda", **overrides) -> ContinuousBuilder:
    cfg = ContinuousConfig(algo=algo, **overrides)
    return ContinuousBuilder(spec, cfg, seed, device=device)
