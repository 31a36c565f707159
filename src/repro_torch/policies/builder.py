"""The acting half of ``repro.policies.builder``: ``TransformerPolicy``.

``TransformerPolicyBuilder`` (replay, adders, the sequence double-DQN
learner) comes with the training slice; until then a caller builds the
policy from ``network.make_arch`` and a ``TransformerPolicyConfig``.
"""
from __future__ import annotations

import torch

from repro_torch.policies import network
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
