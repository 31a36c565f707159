"""Sequence double-DQN learning for the transformer policy.

The learner's forward pass is ``network.q_sequence`` — FULL-sequence
recompute over replayed (B, T) observation windows with the same banded
(``sliding_window``) attention the acting path evaluates incrementally
through the KV cache, so learner and actor compute the same function.  On
the card both passes run the CUDA flash-attention kernel: the online pass
through ``FlashAttentionFunction`` (kernel forward, plain-recompute
backward), the target pass, under ``no_grad``, through the kernel alone.

Objective: R2D2-style double Q-learning with 1-step-within-sequence
targets, prioritized by a max/mean mix of |TD|.  Positions whose attention
context would differ from acting (a mid-episode sequence's first
``window - 1`` steps see a truncated window) are masked out of the loss.
A step runs on ``TorchLearner``: the loss, the step counter and the
priorities reach the host in one copy, the step's only sync.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import optim, tree
from repro_torch.agents.common import (LearnerState, TorchLearner,
                                       fresh_copy, importance_weights)
from repro_torch.core.types import EnvironmentSpec
from repro_torch.optim.optimizers import AdamState
from repro_torch.policies import network
from repro_torch.replay.dataset import ReplaySample


def make_learner(spec: EnvironmentSpec, cfg, iterator: Iterator,
                 generator: torch.Generator, priority_update_cb=None,
                 device="cuda") -> TorchLearner:
    num_actions = spec.actions.num_values
    obs_dim = int(np.prod(spec.observations.shape)) or 1
    arch = network.make_arch(cfg, num_actions)
    opt = optim.adam(cfg.learning_rate, clip=40.0)
    params = network.init(generator, arch, obs_dim, num_actions,
                          device=device)
    state = LearnerState(params, fresh_copy(params), opt.init(params),
                         torch.zeros((), dtype=torch.int32, device=device))

    def loss_fn(params, target_params, sample: ReplaySample):
        seq = sample.data
        obs = seq["observation"].float()                       # (B, T, ...)
        B, T = obs.shape[:2]
        obs = obs.reshape(B, T, -1)
        actions = seq["action"].long()
        rewards = seq["reward"].float()
        discounts = seq["discount"].float() * cfg.discount
        mask = seq["mask"].float()

        q = network.q_sequence(params, arch, obs)              # (B, T, A)
        with torch.no_grad():          # the target: a stop-gradient
            q_target = network.q_sequence(target_params, arch, obs)
            # double Q with 1-step-within-sequence targets
            a_star = torch.argmax(q[:, 1:], dim=-1)
            next_v = torch.gather(q_target[:, 1:], -1,
                                  a_star[..., None])[..., 0]
            y = rewards[:, :-1] + discounts[:, :-1] * next_v
        q_taken = torch.gather(q[:, :-1], -1,
                               actions[:, :-1][..., None])[..., 0]

        # acting-parity mask: a sequence that does NOT start at an episode
        # start has its first window-1 steps attend a truncated context the
        # actor never sees — drop them from the loss (burn-in analogue).
        start = seq["start_of_episode"][:, :1].float()             # (B, 1)
        t_idx = torch.arange(T - 1, dtype=torch.float32,
                             device=obs.device)[None, :]
        full_ctx = (t_idx >= cfg.window - 1).float()
        context_ok = torch.clamp(start + full_ctx, 0.0, 1.0)
        valid = mask[:, :-1] * context_ok
        td = (y - q_taken) * valid

        w = importance_weights(sample.info.probabilities,
                               cfg.importance_beta)
        loss = 0.5 * torch.sum(w[:, None] * torch.square(td)) / torch.clamp(
            torch.sum(valid), min=1.0)
        abs_td = torch.abs(td.detach())
        prio = cfg.priority_eta * torch.amax(abs_td, dim=1) + \
            (1 - cfg.priority_eta) * torch.mean(abs_td, dim=1)
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


def state_from_jax(state, device="cuda") -> LearnerState:
    """The reference learner's ``LearnerState`` (params, target params,
    Adam's step and moments, the step counter) as the port's: each params
    tree through ``network.params_from_jax``."""
    opt = state.opt_state

    def tensor(x):
        return torch.tensor(np.asarray(x), device=device)

    return LearnerState(
        network.params_from_jax(state.params, device),
        network.params_from_jax(state.target_params, device),
        AdamState(tensor(opt.step), network.params_from_jax(opt.mu, device),
                  network.params_from_jax(opt.nu, device)),
        tensor(state.steps))
