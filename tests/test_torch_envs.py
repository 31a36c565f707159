"""The port's host-side spine against the reference: Catch streams, the
environment loop, the variable client and the telemetry registry behave
identically."""
import numpy as np
import pytest
import torch

from repro.core import loop as jax_loop
from repro.core import variable as jax_variable
from repro.envs import Catch as JaxCatch
from repro.telemetry import registry as jax_registry
from repro_torch.core import loop, variable
from repro_torch.envs import Catch
from repro_torch.telemetry import registry


def _stream(env, actions):
    steps = [env.reset()]
    for a in actions:
        steps.append(env.step(a))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_catch_streams_equal(seed):
    actions = np.random.RandomState(seed).randint(0, 3, 60)
    ours = _stream(Catch(seed=seed), actions)
    theirs = _stream(JaxCatch(seed=seed), actions)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.step_type == b.step_type
        assert a.reward == b.reward and a.discount == b.discount
        np.testing.assert_array_equal(a.observation, b.observation)
    ours_spec, theirs_spec = Catch().observation_spec(), \
        JaxCatch().observation_spec()
    assert (ours_spec.shape, ours_spec.dtype, ours_spec.name) == \
        (theirs_spec.shape, theirs_spec.dtype, theirs_spec.name)
    assert Catch().action_spec().num_values == 3


def test_catch_state_round_trip():
    env = Catch(seed=3)
    _stream(env, [0, 1, 2])
    state = env.get_state()
    first = _stream(env, [2] * 12)
    env.set_state(state)
    again = _stream(env, [2] * 12)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.observation, b.observation)


class _FixedActor:
    def __init__(self, seed):
        self._rng = np.random.RandomState(seed)
        self.updates = 0

    def select_action(self, observation):
        return int(self._rng.randint(3))

    def observe_first(self, timestep):
        pass

    def observe(self, action, next_timestep):
        pass

    def update(self, wait=False):
        self.updates += 1


def test_environment_loop_matches_reference():
    ours_actor, theirs_actor = _FixedActor(0), _FixedActor(0)
    ours = loop.EnvironmentLoop(Catch(seed=2), ours_actor,
                                update_period=4).run(num_episodes=4)
    theirs = jax_loop.EnvironmentLoop(JaxCatch(seed=2), theirs_actor,
                                      update_period=4).run(num_episodes=4)
    keys = ("episode_return", "episode_length", "environment_loop_episodes",
            "environment_loop_steps")
    assert [[r[k] for k in keys] for r in ours] == \
        [[r[k] for k in keys] for r in theirs]
    assert ours_actor.updates == theirs_actor.updates == 4 * 9 // 4


def test_counter_matches_reference():
    ours, theirs = loop.Counter(), jax_loop.Counter()
    for c in (ours, theirs):
        c.increment(steps=3, episodes=1)
        c.increment(steps=2)
    assert ours.get_counts() == theirs.get_counts() == {"steps": 5,
                                                        "episodes": 1}


class _CountingSource:
    def __init__(self):
        self.calls = 0

    def get_variables(self, names=("policy",)):
        self.calls += 1
        return [{"w": torch.full((2,), float(self.calls))} for _ in names]


def test_variable_client_fetch_cadence_matches_reference():
    ours_src, theirs_src = _CountingSource(), _CountingSource()
    ours = variable.VariableClient(ours_src, update_period=3)
    theirs = jax_variable.VariableClient(theirs_src, update_period=3)
    for client in (ours, theirs):
        client.params          # noqa: B018 — first access fetches
        for _ in range(10):
            client.update()
        client.update(wait=True)
    assert ours_src.calls == theirs_src.calls
    state = ours.state_dict()
    assert isinstance(state["params"][0]["w"], np.ndarray)
    restored = variable.VariableClient(ours_src, update_period=3)
    restored.load_state_dict(state)
    np.testing.assert_array_equal(restored.params["w"],
                                  state["params"][0]["w"])


def _exercise(reg):
    c = reg.counter("a/count")
    g = reg.gauge("a/level")
    h = reg.histogram("a/latency_ms", max_samples=8)
    for i in range(50):
        c.inc()
        g.set(i)
        h.observe(float(i))
    reg.probe("a/probe", lambda: {"x": 1.5, "skipped": "text"})
    return reg.snapshot()


def test_telemetry_registry_matches_reference():
    ours = _exercise(registry.MetricRegistry(enabled=True))
    theirs = _exercise(jax_registry.MetricRegistry(enabled=True))
    assert ours == theirs
    assert registry.merge_snapshots({"n1": ours, "n2": ours}) == \
        jax_registry.merge_snapshots({"n1": theirs, "n2": theirs})
    disabled = registry.MetricRegistry(enabled=False)
    assert not disabled.histogram("x")
    assert disabled.snapshot() == {}
