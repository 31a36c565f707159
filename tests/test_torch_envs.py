"""The port's host-side spine against the reference: Catch streams, the
vectorized env, the environment loops, the variable client and the
telemetry registry behave identically."""
import numpy as np
import pytest
import torch

from repro.core import loop as jax_loop
from repro.core import variable as jax_variable
from repro.envs import Catch as JaxCatch
from repro.envs import vector as jax_vector
from repro.telemetry import registry as jax_registry
from repro_torch.core import loop, variable
from repro_torch.envs import Catch, VectorEnv, split_timestep
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


def _assert_timesteps_equal(a, b):
    np.testing.assert_array_equal(a.step_type, b.step_type)
    np.testing.assert_array_equal(a.reward, b.reward)
    np.testing.assert_array_equal(a.discount, b.discount)
    np.testing.assert_array_equal(a.observation, b.observation)
    assert a.reward.dtype == b.reward.dtype
    assert a.observation.dtype == b.observation.dtype


@pytest.mark.parametrize("num_envs", [1, 4])
def test_vector_env_streams_match_reference(num_envs):
    """Stacked timesteps with auto-reset (a LAST slot is reset, not
    stepped, on the next call), the per-env split views, and a state
    round trip mid-episode."""
    ours = VectorEnv(lambda s: Catch(seed=s), num_envs, seed=5)
    theirs = jax_vector.VectorEnv(lambda s: JaxCatch(seed=s), num_envs,
                                  seed=5)
    _assert_timesteps_equal(ours.reset(), theirs.reset())
    rng = np.random.RandomState(num_envs)
    saw_reset = False
    for _ in range(25):
        actions = rng.randint(0, 3, num_envs)
        a, b = ours.step(actions), theirs.step(actions)
        _assert_timesteps_equal(a, b)
        for i in range(num_envs):
            x, y = split_timestep(a, i), jax_vector.split_timestep(b, i)
            assert (x.step_type, x.reward, x.discount) == \
                (y.step_type, y.reward, y.discount)
        saw_reset |= bool((a.step_type == 0).any())
    assert saw_reset                         # an auto-reset slot was seen
    state = ours.get_state()
    actions = rng.randint(0, 3, (12, num_envs))
    first = [ours.step(x) for x in actions]
    ours.set_state(state)
    for x, expected in zip(actions, first):
        _assert_timesteps_equal(ours.step(x), expected)
    with pytest.raises(ValueError):
        ours.step(np.zeros(num_envs + 1, np.int64))
    assert ours.observation_spec().shape == (10, 5)


class _FixedBatchedActor:
    """Per-env recording actor with numpy-drawn actions."""

    def __init__(self, num_envs, seed):
        self._rng = np.random.RandomState(seed)
        self._n = num_envs
        self.events = []
        self.updates = 0

    def select_action(self, observation):
        assert observation.shape[0] == self._n
        return self._rng.randint(0, 3, self._n)

    def observe_first(self, timestep, env_id=0):
        self.events.append(("first", env_id,
                            timestep.observation.tobytes()))

    def observe(self, action, next_timestep, env_id=0):
        self.events.append(("add", env_id, int(action), next_timestep.reward,
                            next_timestep.discount,
                            int(next_timestep.step_type)))

    def update(self, wait=False):
        self.updates += 1


def test_vectorized_loop_matches_reference():
    """The same per-env observe_first/observe stream, results and counters
    as the reference's VectorizedEnvironmentLoop, over resumed runs."""
    runs = []
    for loop_mod, vec_mod, catch in ((loop, None, Catch),
                                     (jax_loop, jax_vector, JaxCatch)):
        make_vec = VectorEnv if vec_mod is None else vec_mod.VectorEnv
        actor = _FixedBatchedActor(3, seed=4)
        vloop = loop_mod.VectorizedEnvironmentLoop(
            make_vec(lambda s, c=catch: c(seed=s), 3), actor, update_period=2)
        results = vloop.run(num_episodes=4) + vloop.run(num_steps=20)
        keys = ("episode_return", "episode_length", "env_id",
                "environment_loop_episodes", "environment_loop_steps")
        runs.append(([[r[k] for k in keys] for r in results], actor.events,
                     actor.updates, vloop.state_dict()))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) >= 4


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


# ------------------------------------------ the envs beside Catch
def _new_env_pairs():
    """(name, port factory, reference factory, action draw) for every env
    the port added beside Catch; each factory takes a seed."""
    from repro import envs as jax_envs
    from repro_torch import envs

    def discrete(n):
        return lambda rng: int(rng.randint(n))

    def force(rng):
        return rng.uniform(-1.5, 1.5, (1,)).astype(np.float32)

    return [
        ("deep_sea", lambda s: envs.DeepSea(size=6, seed=s),
         lambda s: jax_envs.DeepSea(size=6, seed=s), discrete(2)),
        ("deep_sea_stochastic",
         lambda s: envs.DeepSea(size=6, stochastic=True, seed=s),
         lambda s: jax_envs.DeepSea(size=6, stochastic=True, seed=s),
         discrete(2)),
        ("memory_chain", lambda s: envs.MemoryChain(memory_length=5, seed=s),
         lambda s: jax_envs.MemoryChain(memory_length=5, seed=s),
         discrete(2)),
        ("bandit", lambda s: envs.Bandit(seed=s),
         lambda s: jax_envs.Bandit(seed=s), discrete(11)),
        ("cartpole", lambda s: envs.CartpoleSwingup(seed=s, episode_len=50),
         lambda s: jax_envs.CartpoleSwingup(seed=s, episode_len=50), force),
        ("pendulum", lambda s: envs.PendulumSwingup(seed=s, episode_len=50),
         lambda s: jax_envs.PendulumSwingup(seed=s, episode_len=50), force),
        ("token_chain",
         lambda s: envs.TokenChain(vocab_size=16, episode_len=20, seed=s),
         lambda s: jax_envs.TokenChain(vocab_size=16, episode_len=20, seed=s),
         discrete(16)),
    ]


_NEW_ENVS = [name for name, *_ in _new_env_pairs()]


def _episodes(env, actions_rng, draw, steps):
    """``steps`` env steps over as many episodes as they span (a reset
    after each last step), the actions drawn from ``actions_rng``."""
    out, actions = [env.reset()], []
    for _ in range(steps):
        if out[-1].last():
            out.append(env.reset())
            continue
        a = draw(actions_rng)
        actions.append(a)
        out.append(env.step(a))
    return out


@pytest.mark.parametrize("seed", [0, 1, 3, 7])
@pytest.mark.parametrize("name", _NEW_ENVS)
def test_new_env_streams_equal(name, seed):
    """The same seed and actions give the reference's TimeStep stream
    exactly, over several episodes, and the same specs."""
    _, port, ref, draw = dict((p[0], p) for p in _new_env_pairs())[name]
    ours = _episodes(port(seed), np.random.RandomState(seed), draw, 120)
    theirs = _episodes(ref(seed), np.random.RandomState(seed), draw, 120)
    assert len(ours) == len(theirs) and sum(t.last() for t in ours) > 0
    for a, b in zip(ours, theirs):
        assert a.step_type == b.step_type
        assert a.reward == b.reward and a.discount == b.discount
        assert type(a.reward) is type(b.reward)
        np.testing.assert_array_equal(a.observation, b.observation)
        assert np.asarray(a.observation).dtype == \
            np.asarray(b.observation).dtype
    for spec_fn in ("observation_spec", "action_spec"):
        ours_spec, theirs_spec = (getattr(port(seed), spec_fn)(),
                                  getattr(ref(seed), spec_fn)())
        assert type(ours_spec).__name__ == type(theirs_spec).__name__
        assert (ours_spec.shape, ours_spec.dtype, ours_spec.name) == \
            (theirs_spec.shape, theirs_spec.dtype, theirs_spec.name)
        assert getattr(ours_spec, "num_values", None) == \
            getattr(theirs_spec, "num_values", None)


@pytest.mark.parametrize("size", [4, 5, 6, 10])
def test_deep_sea_optimal_action_matches_reference(size):
    """``optimal_action`` reads the same per-cell action map: following it
    reaches the treasure in both packages, cell by cell alike."""
    from repro import envs as jax_envs
    from repro_torch import envs
    ours, theirs = envs.DeepSea(size=size, seed=1), \
        jax_envs.DeepSea(size=size, seed=1)
    ts, ref_ts = ours.reset(), theirs.reset()
    total = 0.0
    while not ts.last():
        a = ours.optimal_action()
        assert a == theirs.optimal_action()
        ts, ref_ts = ours.step(a), theirs.step(a)
        assert ts.reward == ref_ts.reward
        total += ts.reward
    assert total > 0.98


@pytest.mark.parametrize("name", _NEW_ENVS)
def test_new_env_contract(name):
    """tests/test_envs.py's contract, on the port's env: a FIRST step with
    no reward, observations that fit the spec, float rewards, and an
    episode that ends with discount 0 or 1."""
    from repro_torch.core import StepType, make_environment_spec
    _, port, _, draw = dict((p[0], p) for p in _new_env_pairs())[name]
    env = port(0)
    spec = make_environment_spec(env)
    ts = env.reset()
    assert ts.step_type == StepType.FIRST
    assert ts.reward is None
    spec.observations.validate(ts.observation)
    rng = np.random.RandomState(0)
    steps = 0
    while not ts.last() and steps < 2000:
        ts = env.step(draw(rng))
        assert isinstance(ts.reward, float) or np.isscalar(ts.reward)
        spec.observations.validate(ts.observation)
        steps += 1
    assert ts.last(), "episode must terminate"
    assert ts.discount == 0.0 or ts.discount == 1.0
