"""IMPALA (§3.3): advantage actor-critic with V-trace off-policy correction.

Data flows through a FIFO queue (non-overlapping sequences, processed in
order) exactly as the paper describes.  The behaviour logits are stored by
the actor as extras so the learner can form the importance ratios.

V-trace runs through ``kernels.ops.vtrace``: the hand-written CUDA kernel
for CUDA tensors, its plain version for CPU tensors.  (The JAX package's
learner calls its jnp oracle ``vtrace_ref``, ``repro/agents/impala.py:95``,
not its Pallas kernel, whatever its docstring says.)  Both V-trace outputs
enter the loss only under a stop-gradient, so the learner calls it on
detached inputs and needs no backward kernel: the gradients are the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import optim, tree
from repro_torch.agents.common import LearnerState, TorchLearner
from repro_torch.builders import AgentBuilder, BuilderOptions
from repro_torch.core.actors import BatchedFeedForwardActor, FeedForwardActor
from repro_torch.core.types import EnvironmentSpec
from repro_torch.kernels import ops
from repro_torch.networks.mlp import flatten_obs, mlp_apply, mlp_init
from repro_torch.replay.dataset import ReplaySample


@dataclasses.dataclass
class IMPALAConfig:
    hidden: int = 64
    learning_rate: float = 6e-4
    discount: float = 0.99
    sequence_length: int = 20
    batch_size: int = 16
    entropy_cost: float = 0.01
    baseline_cost: float = 0.5
    max_queue_size: int = 1000
    clip_rho: float = 1.0
    clip_c: float = 1.0


def make_network(spec: EnvironmentSpec, cfg: IMPALAConfig, device="cuda"):
    num_actions = spec.actions.num_values
    in_dim = int(np.prod(spec.observations.shape)) or 1

    def init(generator: torch.Generator):
        return {
            "torso": mlp_init(generator, (in_dim, cfg.hidden, cfg.hidden),
                              device),
            "policy": mlp_init(generator, (cfg.hidden, num_actions), device),
            "value": mlp_init(generator, (cfg.hidden, 1), device),
        }

    def apply(params, obs):
        h = mlp_apply(params["torso"], obs, activate_final=True)
        return (mlp_apply(params["policy"], h),
                mlp_apply(params["value"], h)[..., 0])

    return init, apply, in_dim, num_actions


def params_from_jax(params, device="cuda"):
    """The reference's ``{"torso", "policy", "value"}`` lists of
    ``{"w", "b"}``, copied leaf for leaf into f32 tensors on ``device``."""
    return tree.map(lambda x: torch.as_tensor(np.array(x, np.float32),
                                              device=device), params)


def _time_major(x):
    """(B, T) -> a detached (T, B) view, without a copy: the kernel reads
    the transpose of a contiguous (B, T) tensor as it is."""
    return x.detach().transpose(0, 1)


def make_learner(spec: EnvironmentSpec, cfg: IMPALAConfig, iterator: Iterator,
                 generator: torch.Generator, device="cuda") -> TorchLearner:
    init, apply, in_dim, num_actions = make_network(spec, cfg, device)
    opt = optim.adam(cfg.learning_rate, clip=40.0)
    params = init(generator)
    state = LearnerState(params, (), opt.init(params),
                         torch.zeros((), dtype=torch.int32, device=device))

    def loss_fn(params, sample: ReplaySample):
        seq = sample.data                          # dict of (B, T, ...)
        obs = seq["observation"].float()
        B, T = obs.shape[:2]
        flat = obs.reshape(B * T, -1)
        logits, values = apply(params, flat)
        logits = logits.reshape(B, T, num_actions)
        values = values.reshape(B, T)
        actions = seq["action"].long()
        rewards = seq["reward"].float()
        discounts = seq["discount"].float() * cfg.discount
        mask = seq["mask"].float()
        behavior_logits = seq["behavior_logits"].float()

        # learner vs behaviour importance ratios
        logp = F.log_softmax(logits, dim=-1)
        logp_a = torch.gather(logp, -1, actions[..., None])[..., 0]
        blogp = F.log_softmax(behavior_logits, dim=-1)
        blogp_a = torch.gather(blogp, -1, actions[..., None])[..., 0]
        rhos = torch.exp(logp_a - blogp_a)

        # bootstrap: V(o_{t+1}) approximated by shifting values
        next_values = torch.cat([values[:, 1:], values[:, -1:]], dim=1)
        vs, pg_adv = ops.vtrace(
            _time_major(values), _time_major(next_values),
            _time_major(rewards), _time_major(discounts), _time_major(rhos),
            clip_rho=cfg.clip_rho, clip_c=cfg.clip_c)
        vs, pg_adv = vs.transpose(0, 1), pg_adv.transpose(0, 1)

        m = mask
        pg_loss = -torch.sum(logp_a * pg_adv * m) / torch.sum(m)
        v_loss = 0.5 * torch.sum(torch.square(vs - values) * m) \
            / torch.sum(m)
        probs = F.softmax(logits, dim=-1)
        entropy = -torch.sum(torch.sum(probs * logp, -1) * m) / torch.sum(m)
        loss = pg_loss + cfg.baseline_cost * v_loss \
            - cfg.entropy_cost * entropy
        return loss, {"loss": loss, "pg_loss": pg_loss, "v_loss": v_loss,
                      "entropy": entropy}

    def update(state: LearnerState, sample: ReplaySample):
        leaves, treedef = tree.flatten(state.params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = loss_fn(tree.unflatten(treedef, leaves), sample)
        grads = tree.unflatten(treedef, torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            params = optim.apply_updates(state.params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (LearnerState(params, (), opt_state, state.steps + 1),
                metrics, None)

    return TorchLearner(state, update, iterator, device=device)


def make_behavior_policy(spec: EnvironmentSpec, cfg: IMPALAConfig):
    """``policy(params, generator, obs (N, ...)) -> (actions (N,) int32,
    logits (N, A))``; an action is drawn from the softmax of its logits by
    the Gumbel-max trick, as ``jax.random.categorical`` draws it."""
    _, apply, _, _ = make_network(spec, cfg)
    tiny = torch.finfo(torch.float32).tiny

    def policy(params, generator, obs):
        obs = flatten_obs(obs, spec.observations.shape)
        logits, _ = apply(params, obs)
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        action = torch.argmax(logits + gumbel, dim=-1)
        return action.to(torch.int32), logits

    return policy


class IMPALAActor(FeedForwardActor):
    """Feed-forward actor that also records behaviour logits as extras."""

    def __init__(self, policy, variable_client, adder, rng_seed=0,
                 device="cuda"):
        super().__init__(policy, variable_client, adder, rng_seed=rng_seed,
                         device=device)
        self._last_logits = None

    def select_action(self, observation):
        action, self._last_logits = self._run_policy(observation)
        return action

    def observe(self, action, next_timestep):
        if self._adder:
            self._adder.add(action, next_timestep,
                            extras={"behavior_logits": self._last_logits})


class BatchedIMPALAActor(BatchedFeedForwardActor):
    """Vectorized IMPALA acting: one batched call returns N (action,
    logits) pairs; each env's behaviour logits ride into its own adder."""

    def __init__(self, policy, variable_client, adders, rng_seed=0,
                 device="cuda"):
        super().__init__(policy, variable_client, adders, rng_seed=rng_seed,
                         device=device)
        self._last_logits = None

    def select_action(self, observation):
        actions, self._last_logits = self._run_policy(observation)
        return actions

    def observe(self, action, next_timestep, env_id: int = 0):
        adder = self._adder(env_id)
        if adder:
            adder.add(action, next_timestep,
                      extras={"behavior_logits": self._last_logits[env_id]})


class IMPALABuilder(AgentBuilder):
    def __init__(self, spec: EnvironmentSpec, cfg: IMPALAConfig = None,
                 seed: int = 0, device="cuda"):
        cfg = cfg or IMPALAConfig()
        # near on-policy: sync weights every step; step the learner as soon
        # as the queue holds a full batch (the Agent's can_step guard
        # prevents blocking on a short queue).
        super().__init__(BuilderOptions(
            variable_update_period=1,
            min_observations=cfg.sequence_length * cfg.batch_size,
            observations_per_step=1.0,
            batch_size=cfg.batch_size), device=device)
        self.spec = spec
        self.cfg = cfg
        self.seed = seed

    def make_replay(self):
        from repro_torch import replay as r
        return r.Table("queue", self.cfg.max_queue_size, r.Fifo(),
                       r.MinSize(self.cfg.batch_size))

    def make_adder(self, table):
        from repro_torch.adders.sequence import SequenceAdder
        return SequenceAdder(table, self.cfg.sequence_length,
                             period=self.cfg.sequence_length)

    def make_dataset(self, table):
        from repro_torch.replay import as_iterator
        return as_iterator(table, self.cfg.batch_size)

    def make_learner(self, iterator, priority_update_cb=None):
        return make_learner(self.spec, self.cfg, iterator,
                            torch.Generator().manual_seed(self.seed),
                            device=self.device)

    def make_policy(self, evaluation: bool = False):
        return make_behavior_policy(self.spec, self.cfg)

    def make_actor(self, policy, variable_client, adder, seed: int = 0):
        return IMPALAActor(policy, variable_client, adder, rng_seed=seed,
                           device=self.device)

    def make_batched_actor(self, policy, variable_client, adders,
                           seed: int = 0):
        return BatchedIMPALAActor(policy, variable_client, adders,
                                  rng_seed=seed, device=self.device)
