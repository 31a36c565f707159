"""Minimal optax-style optimizers, as plain functions on trees of tensors.

An :class:`Optimizer` is a pair of functions ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; ``apply_updates`` adds
updates to params.  Includes Adam(W), SGD+momentum, global-norm clipping,
LR schedules, and the paper's target-network update helpers (periodic copy
for DQN-family, EMA for MPO-family).

Functional rather than ``torch.optim``, as in the JAX package: the state is
a tree with the reference's leaves (an int32 step counter and f32 moments),
so it compares and checkpoints leaf for leaf.  Step counters are 0-d int32
tensors on the params' device, and every step-dependent factor (bias
correction, schedules) is computed from them in f32 on that device, as the
reference computes it from its int32 step.  No update copies a host number
to the device (such a copy waits for the device), so a step queues without
a sync.  Callers run ``update`` under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch import tree

OptState = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple]


def global_norm(params) -> torch.Tensor:
    leaves = tree.leaves(params)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def apply_updates(params, updates):
    return tree.map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def _to_schedule(lr: Union[float, Schedule]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def _zero_step(params) -> torch.Tensor:
    leaves = tree.leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def _zeros(params):
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _clip(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree.map(lambda g: g * scale, grads)


def _power(base: float, step: torch.Tensor) -> torch.Tensor:
    """``base ** step`` in f32, as the reference computes it from its int32
    step (not in float64 on the host); the Python base is cast to f32 in
    the kernel, with no host-to-device copy."""
    return torch.pow(base, step.float())


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adam(lr: Union[float, Schedule], b1=0.9, b2=0.999, eps=1e-8,
         weight_decay: float = 0.0, clip: Optional[float] = None) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params):
        return AdamState(_zero_step(params), _zeros(params), _zeros(params))

    def update(grads, state: AdamState, params=None):
        grads = tree.map(lambda g: g.float(), grads)
        if clip is not None:
            grads = _clip(grads, clip)
        step = state.step + 1
        mu = tree.map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree.map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        correct1 = 1 - _power(b1, step)
        correct2 = 1 - _power(b2, step)
        mu_hat = tree.map(lambda m: m / correct1, mu)
        nu_hat = tree.map(lambda v: v / correct2, nu)
        lr_t = sched(step)
        updates = tree.map(lambda m, v: -lr_t * m / (torch.sqrt(v) + eps),
                           mu_hat, nu_hat)
        if weight_decay and params is not None:
            updates = tree.map(
                lambda u, p: u - lr_t * weight_decay * p.float(),
                updates, params)
        return updates, AdamState(step, mu, nu)

    return Optimizer(init, update)


class SgdState(NamedTuple):
    step: torch.Tensor
    momentum: Any


def sgd(lr: Union[float, Schedule], momentum: float = 0.0,
        clip: Optional[float] = None) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params):
        return SgdState(_zero_step(params), _zeros(params))

    def update(grads, state: SgdState, params=None):
        grads = tree.map(lambda g: g.float(), grads)
        if clip is not None:
            grads = _clip(grads, clip)
        step = state.step + 1
        mom = tree.map(lambda m, g: momentum * m + g, state.momentum, grads)
        lr_t = sched(step)
        return tree.map(lambda m: -lr_t * m, mom), SgdState(step, mom)

    return Optimizer(init, update)


def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    """Prepend global-norm clipping to any optimizer."""
    def update(grads, state, params=None):
        return opt.update(_clip(grads, max_norm), state, params)
    return Optimizer(opt.init, update)


def linear_warmup(base: float, warmup_steps: int) -> Schedule:
    def sched(step):
        return base * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    return sched


def cosine_schedule(base: float, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1) -> Schedule:
    def sched(step):
        step = step.float()
        warm = step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return base * torch.where(step < warmup_steps, warm, cos)
    return sched


# ------------------------------------------------------- target networks
def periodic_update(online, target, step, period: int):
    """DQN-style: copy online -> target every ``period`` steps."""
    copy = torch.as_tensor((step % period) == 0)
    return tree.map(lambda o, t: torch.where(copy.to(o.device), o, t),
                    online, target)


def incremental_update(online, target, tau: float):
    """EMA target (MPO/DDPG-style soft update)."""
    return tree.map(lambda o, t: tau * o + (1 - tau) * t, online, target)
