"""``TransformerPolicyBuilder``: the transformer policy as an Acme agent.

Implements the ``AgentBuilder`` protocol: a sequence adder through the
prioritized replay, the sequence double-DQN learner over replayed windows
(flash attention on the card), and windowed actors running incremental
KV-cache decode through a ``PolicyEngine`` (decode attention on the card).
With ``inference="server"`` one ``TransformerInferenceServer`` on the
builder's device serves every actor's windows, and the actors hold no
network.
"""
from __future__ import annotations

import torch

from repro_torch.builders import AgentBuilder, BuilderOptions
from repro_torch.core.types import EnvironmentSpec
from repro_torch.policies import learning, network
from repro_torch.policies.config import TransformerPolicyConfig
from repro_torch.policies.engine import PolicyEngine


class TransformerPolicy:
    """The policy as a plain ``(params, generator, obs) -> action`` callable.

    ``obs`` is ``{"window": (W, *obs_shape), "length": ()}`` — a full
    left-aligned observation window; the forward pass is FULL-sequence
    recompute (``q_sequence``), which makes this the parity oracle for the
    engine's incremental KV-cache decode.  It also carries the arch/shape
    metadata actors and servers derive engines from.
    """

    def __init__(self, arch, obs_shape, num_actions: int, epsilon: float,
                 backend: str, cache_slots: int, slot_timeout_s: float):
        self.arch = arch
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.epsilon = float(epsilon)
        self.backend = backend
        self.cache_slots = cache_slots
        self.slot_timeout_s = slot_timeout_s

    @torch.no_grad()
    def __call__(self, params, generator, obs):
        """One action; ``generator`` is a ``torch.Generator`` on the
        parameters' device and draws the exploration."""
        window = torch.as_tensor(obs["window"], dtype=torch.float32,
                                 device=params["head"].device)
        length = int(obs["length"])
        q = network.q_sequence(params, self.arch,
                               window.reshape(1, window.shape[0], -1))[0]
        greedy = torch.argmax(q[max(length - 1, 0)])
        device = greedy.device
        rand = torch.randint(0, self.num_actions, (), generator=generator,
                             device=device)
        explore = torch.rand((), generator=generator,
                             device=device) < self.epsilon
        return torch.where(explore, rand, greedy)

    def make_engine(self, *, num_slots: int, rng_seed: int = 0,
                    device="cuda") -> PolicyEngine:
        return PolicyEngine(self.arch, self.obs_shape, self.num_actions,
                            num_slots=num_slots, epsilon=self.epsilon,
                            backend=self.backend,
                            slot_timeout_s=self.slot_timeout_s,
                            rng_seed=rng_seed, device=device)


class TransformerPolicyBuilder(AgentBuilder):
    """DQN-style agent whose Q-network is a windowed transformer."""

    def __init__(self, spec: EnvironmentSpec,
                 cfg: TransformerPolicyConfig = None, seed: int = 0,
                 device="cuda"):
        cfg = cfg or TransformerPolicyConfig()
        super().__init__(BuilderOptions(
            variable_update_period=10,
            min_observations=cfg.min_replay_size,
            observations_per_step=max(float(cfg.period), 1.0),
            batch_size=cfg.batch_size), device=device)
        self.spec = spec
        self.cfg = cfg
        self.seed = seed
        self.num_actions = spec.actions.num_values
        self.arch = network.make_arch(cfg, self.num_actions)

    # ------------------------------------------------------- replay pipeline
    def make_replay(self):
        from repro_torch import replay as r
        cfg = self.cfg
        if cfg.samples_per_insert > 0:
            limiter = r.SampleToInsertRatio(
                cfg.samples_per_insert, cfg.min_replay_size // cfg.period + 1,
                error_buffer=max(2 * cfg.samples_per_insert * cfg.batch_size,
                                 100))
        else:
            limiter = r.MinSize(max(cfg.min_replay_size // cfg.period, 1))
        return r.Table("replay", cfg.max_replay_size, r.Prioritized(),
                       limiter)

    def make_adder(self, table):
        from repro_torch.adders.sequence import SequenceAdder
        return SequenceAdder(table, self.cfg.sequence_length,
                             period=self.cfg.period, priority=100.0)

    def make_dataset(self, table):
        from repro_torch.replay import as_iterator
        return as_iterator(table, self.cfg.batch_size)

    def make_learner(self, iterator, priority_update_cb=None):
        return learning.make_learner(self.spec, self.cfg, iterator,
                                     torch.Generator().manual_seed(self.seed),
                                     priority_update_cb=priority_update_cb,
                                     device=self.device)

    # --------------------------------------------------------------- acting
    def make_policy(self, evaluation: bool = False):
        return TransformerPolicy(
            self.arch, self.spec.observations.shape, self.num_actions,
            epsilon=0.0 if evaluation else self.cfg.epsilon,
            backend=self.cfg.backend, cache_slots=self.cfg.cache_slots,
            slot_timeout_s=self.cfg.slot_timeout_s)

    def make_actor(self, policy, variable_client, adder, seed: int = 0):
        from repro_torch.policies.actors import WindowedPolicyActor
        engine = policy.make_engine(num_slots=1, rng_seed=seed,
                                    device=self.device)
        return WindowedPolicyActor(engine, variable_client, adder)

    def make_batched_actor(self, policy, variable_client, adders,
                           seed: int = 0):
        from repro_torch.policies.actors import BatchedWindowedPolicyActor
        engine = policy.make_engine(num_slots=max(len(adders), 1),
                                    rng_seed=seed, device=self.device)
        return BatchedWindowedPolicyActor(engine, variable_client, adders)

    # -------------------------------------------------------------- serving
    def make_inference_server(self, variable_source, *, max_batch_size: int,
                              max_wait_ms: float, update_period: int,
                              rng_seed: int = 0):
        from repro_torch.policies.serving import TransformerInferenceServer
        policy = self.make_policy(evaluation=False)
        engine = policy.make_engine(
            num_slots=max(self.cfg.cache_slots, max_batch_size),
            rng_seed=rng_seed, device=self.device)
        return TransformerInferenceServer(
            engine, variable_source, max_batch_size=max_batch_size,
            max_wait_ms=max_wait_ms, update_period=update_period)

    def make_inference_actor(self, inference, adder=None, adders=None):
        from repro_torch.policies.actors import WindowedInferenceClientActor
        if adders is not None:
            return WindowedInferenceClientActor(inference, adders=adders,
                                                batched=True)
        return WindowedInferenceClientActor(inference, adder=adder)
