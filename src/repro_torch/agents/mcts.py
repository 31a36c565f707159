"""MCTS agent (§3.5): AlphaZero-lite — planning with a (perfect) simulator,
search guided by policy/value networks, UCT selection (Eq. 19), policy
trained by KL to the visit-count distribution (Eq. 20), value by TD.

The search (UCT selection, expansion, backup, the visit-count
distribution) is host code, as in the JAX package.  ``_evaluate`` runs the
network on the actor's device, on one device copy of the client's params a
params object, and brings the priors and the value to the host in one
copy: a search waits for the device once per expansion.  The action draw
is the reference's ``np.random.RandomState(seed)``, so from the same
params, simulator state and seed the actions are the reference's.  The
learner runs on ``TorchLearner`` (one host copy a step, its only sync).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Iterator

import numpy as np
import torch

from repro_torch import optim, tree
from repro_torch.agents.common import (LearnerState, TorchLearner,  # noqa: F401
                                       state_from_jax)
from repro_torch.builders import AgentBuilder, BuilderOptions
from repro_torch.core.types import EnvironmentSpec
from repro_torch.networks.mlp import flatten_obs, mlp_apply, mlp_init
from repro_torch.replay.dataset import ReplaySample


@dataclasses.dataclass
class MCTSConfig:
    hidden: int = 64
    learning_rate: float = 1e-3
    discount: float = 0.99
    num_simulations: int = 32
    uct_c: float = 1.25
    search_depth: int = 16
    batch_size: int = 32
    min_replay_size: int = 100
    max_replay_size: int = 50_000
    temperature: float = 1.0


def make_network(spec: EnvironmentSpec, cfg: MCTSConfig, device="cuda"):
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


class _Node:
    __slots__ = ("prior", "value_sum", "visits", "children", "reward",
                 "terminal")

    def __init__(self, prior: float):
        self.prior = prior
        self.value_sum = 0.0
        self.visits = 0
        self.children = {}
        self.reward = 0.0
        self.terminal = False

    @property
    def value(self):
        return self.value_sum / self.visits if self.visits else 0.0


class MCTSActor:
    """Actor that plans with a copyable simulator (env must support
    deepcopy — all our envs do)."""

    def __init__(self, spec, cfg: MCTSConfig, variable_client, adder=None,
                 model_env=None, seed: int = 0, device="cuda"):
        self.spec = spec
        self.cfg = cfg
        self._client = variable_client
        self._adder = adder
        _, self._apply, _, self.num_actions = make_network(spec, cfg)
        self._device = torch.device(device)
        self._host_params = None
        self._params = None
        self._rng = np.random.RandomState(seed)
        self._model_env = model_env
        self._last_probs = None

    def _device_params(self):
        """The client's params on the actor's device, copied once per
        params object the client hands out."""
        host = self._client.params
        if host is not self._host_params:
            self._params = tree.map(
                lambda x: torch.as_tensor(x, device=self._device), host)
            self._host_params = host
        return self._params

    def _evaluate(self, obs):
        x = torch.as_tensor(np.asarray(obs, np.float32))
        if self._device.type == "cuda":
            # from pinned memory the upload is queued without a wait, so
            # the copy of the priors back is the one sync
            x = x.pin_memory().to(self._device, non_blocking=True)
        with torch.no_grad():
            logits, value = self._apply(
                self._device_params(),
                flatten_obs(x, self.spec.observations.shape))
            # priors and value to the host in one copy
            out = torch.cat([torch.softmax(logits[0], -1),
                             value[:1]]).cpu().numpy()
        return out[:-1], float(out[-1])

    def _search(self, env, root_obs) -> np.ndarray:
        priors, _ = self._evaluate(root_obs)
        root = _Node(1.0)
        for a in range(self.num_actions):
            root.children[a] = _Node(float(priors[a]))

        for _ in range(self.cfg.num_simulations):
            sim = copy.deepcopy(env)
            node = root
            path = [node]
            depth = 0
            value = 0.0
            # selection + expansion
            while depth < self.cfg.search_depth:
                best_a, best_score = None, -1e9
                sqrt_n = math.sqrt(max(node.visits, 1))
                for a, child in node.children.items():
                    u = self.cfg.uct_c * sqrt_n / (child.visits + 1) * child.prior
                    score = child.value + u
                    if score > best_score:
                        best_a, best_score = a, score
                child = node.children[best_a]
                ts = sim.step(best_a)
                child.reward = float(ts.reward or 0.0)
                depth += 1
                path.append(child)
                node = child
                if ts.last():
                    child.terminal = True
                    value = 0.0
                    break
                if not child.children:
                    priors, value = self._evaluate(ts.observation)
                    for a in range(self.num_actions):
                        child.children[a] = _Node(float(priors[a]))
                    break
            # backup
            g = value
            for n in reversed(path[1:]):
                g = n.reward + self.cfg.discount * g
                n.value_sum += g
                n.visits += 1
            root.visits += 1

        visits = np.array([root.children[a].visits
                           for a in range(self.num_actions)], np.float64)
        if visits.sum() == 0:
            visits += 1
        probs = visits ** (1.0 / self.cfg.temperature)
        return probs / probs.sum()

    def select_action(self, observation):
        env = self._model_env
        probs = self._search(env, observation)
        self._last_probs = probs.astype(np.float32)
        return np.int32(self._rng.choice(self.num_actions, p=probs))

    def observe_first(self, timestep):
        if self._adder:
            self._adder.add_first(timestep)

    def observe(self, action, next_timestep):
        if self._adder:
            self._adder.add(action, next_timestep,
                            extras={"search_probs": self._last_probs})

    def update(self, wait=False):
        self._client.update(wait)


def make_learner(spec: EnvironmentSpec, cfg: MCTSConfig, iterator: Iterator,
                 generator: torch.Generator, device="cuda") -> TorchLearner:
    init, apply, _, _ = make_network(spec, cfg, device)
    opt = optim.adam(cfg.learning_rate)
    params = init(generator)
    state = LearnerState(params, (), opt.init(params),
                         torch.zeros((), dtype=torch.int32, device=device))

    def loss_fn(params, seq):
        obs = seq["observation"].float()
        B, T = obs.shape[:2]
        logits, values = apply(params, obs.reshape(B * T, -1))
        logits = logits.reshape(B, T, -1)
        values = values.reshape(B, T)
        probs = seq["search_probs"].float()
        mask = seq["mask"].float()
        # policy: KL(pi_mcts || pi_theta) (Eq. 20)
        logp = torch.log_softmax(logits, -1)
        pi_loss = -torch.sum(probs * logp, -1)
        # value: TD(0) to observed returns
        rewards = seq["reward"].float()
        disc = seq["discount"].float() * cfg.discount
        v_next = torch.cat([values[:, 1:], values[:, -1:]], 1).detach()
        td = rewards + disc * v_next - values
        v_loss = 0.5 * torch.square(td)
        return torch.sum((pi_loss + v_loss) * mask) / torch.clamp(
            torch.sum(mask), min=1.0)

    def update(state: LearnerState, sample: ReplaySample):
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


class MCTSBuilder(AgentBuilder):
    def __init__(self, spec: EnvironmentSpec, model_env_factory,
                 cfg: MCTSConfig = None, seed: int = 0, device="cuda"):
        cfg = cfg or MCTSConfig()
        super().__init__(BuilderOptions(
            variable_update_period=5,
            min_observations=cfg.min_replay_size,
            observations_per_step=4.0,
            batch_size=cfg.batch_size), device=device)
        self.spec = spec
        self.cfg = cfg
        self.seed = seed
        self.model_env_factory = model_env_factory

    def make_replay(self):
        from repro_torch import replay as r
        return r.Table("replay", self.cfg.max_replay_size,
                       r.Uniform(self.seed),
                       r.MinSize(self.cfg.min_replay_size))

    def make_adder(self, table):
        from repro_torch.adders.sequence import SequenceAdder
        return SequenceAdder(table, 10, period=10)

    def make_dataset(self, table):
        from repro_torch.replay import as_iterator
        return as_iterator(table, self.cfg.batch_size)

    def make_learner(self, iterator, priority_update_cb=None):
        return make_learner(self.spec, self.cfg, iterator,
                            torch.Generator().manual_seed(self.seed),
                            device=self.device)

    def make_policy(self, evaluation: bool = False):
        return None   # MCTS plans; no standalone policy fn

    def make_actor(self, policy, variable_client, adder, seed: int = 0):
        # the model env is its own instance, never reset or stepped with
        # the real env, as in the JAX package
        return MCTSActor(self.spec, self.cfg, variable_client, adder,
                         model_env=self.model_env_factory(seed), seed=seed,
                         device=self.device)

    def make_batched_actor(self, policy, variable_client, adders,
                           seed: int = 0):
        raise NotImplementedError(
            "MCTS actors plan with a per-environment simulator; vectorized "
            "acting (num_envs_per_actor > 1) is not supported")
