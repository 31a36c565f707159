"""dm_env-style core types (the container has no dm_env, so we provide the
same interface surface Acme assumes: TimeStep/StepType + Environment + specs).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np


class StepType(enum.IntEnum):
    FIRST = 0
    MID = 1
    LAST = 2


class TimeStep(NamedTuple):
    step_type: StepType
    reward: Optional[float]
    discount: Optional[float]
    observation: Any

    def first(self) -> bool:
        return self.step_type == StepType.FIRST

    def mid(self) -> bool:
        return self.step_type == StepType.MID

    def last(self) -> bool:
        return self.step_type == StepType.LAST


def restart(observation) -> TimeStep:
    return TimeStep(StepType.FIRST, None, None, observation)


def transition(reward, observation, discount=1.0) -> TimeStep:
    return TimeStep(StepType.MID, reward, discount, observation)


def termination(reward, observation) -> TimeStep:
    return TimeStep(StepType.LAST, reward, 0.0, observation)


def truncation(reward, observation, discount=1.0) -> TimeStep:
    return TimeStep(StepType.LAST, reward, discount, observation)


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    shape: Tuple[int, ...]
    dtype: Any
    name: str = ""

    def validate(self, value):
        value = np.asarray(value)
        if tuple(value.shape) != tuple(self.shape):
            raise ValueError(f"{self.name}: shape {value.shape} != {self.shape}")
        return value

    def generate_value(self):
        return np.zeros(self.shape, self.dtype)


@dataclasses.dataclass(frozen=True)
class BoundedArraySpec(ArraySpec):
    minimum: float = -np.inf
    maximum: float = np.inf


@dataclasses.dataclass(frozen=True)
class DiscreteArraySpec(ArraySpec):
    num_values: int = 0

    def __post_init__(self):
        object.__setattr__(self, "shape", ())
        object.__setattr__(self, "dtype", np.int32)


@dataclasses.dataclass(frozen=True)
class EnvironmentSpec:
    observations: Any
    actions: Any
    rewards: ArraySpec
    discounts: ArraySpec


class Environment:
    """dm_env.Environment interface."""

    def reset(self) -> TimeStep:
        raise NotImplementedError

    def step(self, action) -> TimeStep:
        raise NotImplementedError

    def observation_spec(self):
        raise NotImplementedError

    def action_spec(self):
        raise NotImplementedError

    def reward_spec(self) -> ArraySpec:
        return ArraySpec((), np.float32, "reward")

    def discount_spec(self) -> ArraySpec:
        return BoundedArraySpec((), np.float32, "discount", 0.0, 1.0)

    def close(self):
        pass


def make_environment_spec(env: Environment) -> EnvironmentSpec:
    return EnvironmentSpec(
        observations=env.observation_spec(),
        actions=env.action_spec(),
        rewards=env.reward_spec(),
        discounts=env.discount_spec(),
    )


class Transition(NamedTuple):
    """(o_t, a_t, r_t, d_t, o_{t+1}) — with n-step aggregates when adder says."""
    observation: Any
    action: Any
    reward: Any
    discount: Any
    next_observation: Any
    extras: Any = ()
