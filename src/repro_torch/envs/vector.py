"""Vectorized environments: step N copies of any env with stacked arrays.

``VectorEnv`` holds N independent instances built from one ``env_factory``
(each with its own seed) and exposes a batched ``reset``/``step`` whose
``TimeStep`` fields are stacked along a leading ``num_envs`` axis.  This is
the environment half of the batched acting pipeline: a batched actor
evaluates ONE batched policy call per ``step`` instead of N per-env calls.

Auto-reset contract
-------------------
An env whose previous timestep was LAST is *reset* (not stepped) on the next
``step`` call: its slot carries ``StepType.FIRST``, reward 0 and discount 1
(batched arrays cannot hold ``None``), and the action passed for that slot
is ignored.  The terminal observation is therefore always delivered before
the reset observation — per-env streams are indistinguishable from a
single-env ``reset``/``step`` loop, which is what the vectorized loop relies
on to route ``add_first`` vs ``add`` to per-env adders.

``split_timestep`` recovers the per-env ``TimeStep`` view (reward/discount
become ``None`` again on FIRST steps, matching the dm_env convention).
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np

from repro_torch.core import types


def stack_timesteps(steps: List[types.TimeStep]) -> types.TimeStep:
    """Stack per-env timesteps into one batched TimeStep (arrays only)."""
    return types.TimeStep(
        step_type=np.asarray([int(ts.step_type) for ts in steps], np.int32),
        reward=np.asarray([0.0 if ts.reward is None else ts.reward
                           for ts in steps], np.float32),
        discount=np.asarray([1.0 if ts.discount is None else ts.discount
                             for ts in steps], np.float32),
        observation=np.stack([np.asarray(ts.observation) for ts in steps]),
    )


def split_timestep(batched: types.TimeStep, index: int) -> types.TimeStep:
    """The per-env view of slot ``index`` (None reward/discount on FIRST)."""
    step_type = types.StepType(int(batched.step_type[index]))
    if step_type == types.StepType.FIRST:
        return types.TimeStep(step_type, None, None,
                              batched.observation[index])
    return types.TimeStep(step_type,
                          float(batched.reward[index]),
                          float(batched.discount[index]),
                          batched.observation[index])


class VectorEnv(types.Environment):
    """N copies of ``env_factory`` stepped together with auto-reset.

    ``observation_spec``/``action_spec`` describe a SINGLE member env — they
    are what per-example policies and adders see (the batch axis is an
    execution detail, not part of the environment contract).
    """

    def __init__(self, env_factory: Callable[[int], types.Environment],
                 num_envs: int, seed: int = 0):
        if num_envs < 1:
            raise ValueError(f"num_envs must be >= 1, got {num_envs}")
        self._envs = [env_factory(seed + i) for i in range(num_envs)]
        self._needs_reset = np.ones(num_envs, bool)

    @property
    def num_envs(self) -> int:
        return len(self._envs)

    @property
    def envs(self) -> List[types.Environment]:
        return list(self._envs)

    def reset(self) -> types.TimeStep:
        self._needs_reset[:] = False
        return stack_timesteps([env.reset() for env in self._envs])

    def step(self, actions) -> types.TimeStep:
        actions = np.asarray(actions)
        if len(actions) != len(self._envs):
            raise ValueError(
                f"expected {len(self._envs)} actions, got {len(actions)}")
        steps = []
        for i, env in enumerate(self._envs):
            if self._needs_reset[i]:
                # auto-reset: the action for this slot is ignored
                self._needs_reset[i] = False
                steps.append(env.reset())
                continue
            ts = env.step(actions[i])
            if ts.last():
                self._needs_reset[i] = True
            steps.append(ts)
        return stack_timesteps(steps)

    # -- exact resume --------------------------------------------------
    def get_state(self):
        """Member env states (None for envs without ``get_state``) + the
        auto-reset mask — what a run-wide checkpoint captures so a resumed
        vectorized loop continues mid-flight episodes instead of resetting
        every slot."""
        return {"envs": [getattr(env, "get_state", lambda: None)()
                         for env in self._envs],
                "needs_reset": self._needs_reset.copy()}

    def set_state(self, state):
        for env, env_state in zip(self._envs, state["envs"]):
            if env_state is not None and hasattr(env, "set_state"):
                env.set_state(env_state)
        self._needs_reset[:] = np.asarray(state["needs_reset"], bool)

    def observation_spec(self):
        return self._envs[0].observation_spec()

    def action_spec(self):
        return self._envs[0].action_spec()

    def reward_spec(self):
        return self._envs[0].reward_spec()

    def discount_spec(self):
        return self._envs[0].discount_spec()

    def close(self):
        for env in self._envs:
            env.close()
