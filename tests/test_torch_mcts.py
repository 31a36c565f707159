"""repro_torch's MCTS agent against the JAX package: the network's forward
pass with copied weights, the learner (the policy's KL to the search
probabilities plus masked TD(0) on value) after 1 and 10 steps from the
reference's state (``state_from_jax``) on the same sequence batches, the
search's visit counts and the actor's actions from the same params,
simulator state and seed, ``VariableServer``, and the builder (options,
replay, adder, the model env it plans with, and ``make_batched_actor``
raising).

Tolerances: 1e-5 on forward outputs and losses of order 1; params within
1e-4 absolute (summation-order noise in a gradient near Adam's eps moves
its weight by up to ~lr / 50); Adam's moments within 1e-5 of each leaf's
largest magnitude; visit counts, search probabilities and actions equal.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro import replay as jax_replay
from repro.agents import mcts as jax_mcts
from repro.core import VariableClient as JaxVariableClient
from repro.core import make_environment_spec as jax_spec
from repro.core.variable import VariableServer as JaxVariableServer
from repro.envs import Catch as JaxCatch
from repro_torch import replay, tree
from repro_torch.adders.sequence import SequenceAdder
from repro_torch.agents import mcts
from repro_torch.core import (VariableClient, VariableServer,
                              make_environment_spec)
from repro_torch.envs import Catch
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
FWD_TOL = 1e-5
PARAM_ATOL = 1e-4
MOMENT_TOL = 1e-5


def _spec():
    return make_environment_spec(Catch(seed=0))


def _jax_spec():
    return jax_spec(JaxCatch(seed=0))


def _jax_params(cfg, seed=0):
    init, *_ = jax_mcts.make_network(_jax_spec(), cfg)
    return init(jax.random.key(seed))


def _numpy(params):
    return jax.tree.map(lambda x: np.array(x), params)


# ----------------------------------------------------------------- network
@pytest.mark.parametrize("hidden", [64, 16])
def test_network_matches_reference_with_copied_params(hidden):
    cfg = mcts.MCTSConfig(hidden=hidden)
    params = _jax_params(cfg, seed=3)
    obs = np.random.RandomState(0).rand(7, 50).astype(np.float32)
    _, apply, _, _ = jax_mcts.make_network(_jax_spec(), cfg)
    init, port_apply, in_dim, num_actions = mcts.make_network(_spec(), cfg,
                                                              device=CPU)
    assert (in_dim, num_actions) == (50, 3)
    logits, values = apply(params, obs)
    port_logits, port_values = port_apply(
        tree.map(torch.as_tensor, _numpy(params)), torch.as_tensor(obs))
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(logits),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(port_values.numpy(), np.asarray(values),
                               atol=FWD_TOL, rtol=FWD_TOL)
    assert port_values.shape == (7,)
    assert [tuple(x.shape) for x in tree.leaves(
        init(torch.Generator().manual_seed(0)))] == \
        [x.shape for x in jax.tree.leaves(params)]


# ----------------------------------------------------------------- learner
def _batch(B, T, seed):
    """A (B, T) batch as the builder's SequenceAdder writes it: Catch
    boards, actions, rewards at episode ends (discount 0 there),
    visit-count distributions and zero-padded tails (mask 0)."""
    rng = np.random.RandomState(seed)
    obs = np.zeros((B, T, 10, 5), np.float32)
    rows = np.arange(B)[:, None]
    obs[rows, np.arange(T)[None], rng.randint(0, 10, (B, T)),
        rng.randint(0, 5, (B, T))] = 1.0
    obs[rows, np.arange(T)[None], 9, rng.randint(0, 5, (B, T))] = 1.0
    lengths = rng.randint(1, T + 1, B)
    lengths[: B // 2] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    ends = (rng.rand(B, T) < 0.15) * mask
    visits = rng.randint(0, 12, (B, T, 3)).astype(np.float32) + 1e-3
    return {
        "observation": obs * mask[..., None, None],
        "action": (rng.randint(0, 3, (B, T)) * mask).astype(np.int32),
        "reward": (ends * rng.choice([-1.0, 1.0], (B, T))).astype(np.float32),
        "discount": ((1 - ends) * mask).astype(np.float32),
        "start_of_episode": np.arange(T)[None].repeat(B, 0) == 0,
        "search_probs": (visits / visits.sum(-1, keepdims=True)
                         * mask[..., None]).astype(np.float32),
        "mask": mask,
    }


def _samples(cfg, n, port):
    B = cfg.batch_size
    for i in range(n):
        info = (np.arange(B, dtype=np.int64) + i * B, np.full(B, 0.01))
        data = _batch(B, 10, seed=i)
        yield (replay.ReplaySample(replay.SampleInfo(*info), data) if port
               else jax_replay.ReplaySample(jax_replay.SampleInfo(*info),
                                            data))


def _assert_close(port, ref, atol=0.0, rel=None):
    port_leaves = [np.asarray(x) for x in tree.leaves(port)]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(port_leaves) == len(ref_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        if rel is None:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0)
        else:
            assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("hidden", [64, 32])
def test_learner_steps_match_reference(hidden, steps):
    cfg = mcts.MCTSConfig(hidden=hidden, batch_size=8)
    ref = jax_mcts.make_learner(_jax_spec(), cfg, _samples(cfg, steps, False),
                                jax.random.key(0))
    port = mcts.make_learner(_spec(), cfg, _samples(cfg, steps, True),
                             torch.Generator().manual_seed(0), device=CPU)
    port.state = mcts.state_from_jax(_numpy(ref.state), CPU)
    for _ in range(steps):
        ref_metrics, port_metrics = ref.step(), port.step()
        np.testing.assert_allclose(port_metrics["loss"], ref_metrics["loss"],
                                   atol=FWD_TOL, rtol=FWD_TOL)
        assert port_metrics["learner_steps"] == ref_metrics["learner_steps"]
    state, ref_state = port.state, ref.state
    assert state.target_params == () == ref_state.target_params
    _assert_close(state.params, ref_state.params, atol=PARAM_ATOL)
    _assert_close(state.opt_state.mu, ref_state.opt_state.mu, rel=MOMENT_TOL)
    _assert_close(state.opt_state.nu, ref_state.opt_state.nu, rel=MOMENT_TOL)
    assert int(state.steps) == int(ref_state.steps) == steps


# ------------------------------------------------------------------ search
def _actors(cfg, seed, env_seed, params_seed=0):
    params = _jax_params(cfg, seed=params_seed)
    ref_env, env = JaxCatch(seed=env_seed), Catch(seed=env_seed)
    ref = jax_mcts.MCTSActor(_jax_spec(), cfg, JaxVariableClient(
        JaxVariableServer(policy=params)), model_env=ref_env, seed=seed)
    port = mcts.MCTSActor(_spec(), cfg, VariableClient(
        VariableServer(policy=_numpy(params))), model_env=env, seed=seed,
        device=CPU)
    return ref, port, ref_env, env


@pytest.mark.parametrize("sims,depth,temperature", [
    (8, 4, 1.0), (48, 12, 0.25), (20, 16, 1.0)])
def test_search_visit_counts_and_actions_equal_the_reference(
        sims, depth, temperature):
    """Two episodes with each actor planning on the real env, as the
    reference's acceptance does: at every step the search's probabilities
    (visit counts ** 1/temperature, normalized) and the drawn action are
    the reference's."""
    cfg = mcts.MCTSConfig(num_simulations=sims, search_depth=depth,
                          temperature=temperature)
    ref, port, ref_env, env = _actors(cfg, seed=1, env_seed=4)
    steps = 0
    for _ in range(2):
        ref_ts, ts = ref_env.reset(), env.reset()
        while not ts.last():
            np.testing.assert_array_equal(ts.observation, ref_ts.observation)
            probs = port._search(env, ts.observation)
            np.testing.assert_array_equal(
                probs, ref._search(ref_env, ref_ts.observation))
            action = port.select_action(ts.observation)
            ref_action = ref.select_action(ref_ts.observation)
            assert isinstance(action, np.int32) and action == ref_action
            np.testing.assert_array_equal(port._last_probs, ref._last_probs)
            ts, ref_ts = env.step(action), ref_env.step(ref_action)
            steps += 1
    assert steps == 18


def test_search_counts_every_simulation_at_the_root():
    cfg = mcts.MCTSConfig(num_simulations=40, search_depth=12,
                          temperature=1.0)
    _, port, _, env = _actors(cfg, seed=0, env_seed=2)
    ts = env.reset()
    for _ in range(7):
        ts = env.step(1)
    visits = port._search(env, ts.observation) * cfg.num_simulations
    np.testing.assert_allclose(visits.sum(), cfg.num_simulations)
    np.testing.assert_allclose(visits, np.round(visits), atol=1e-9)


def test_evaluate_copies_params_once_and_returns_priors_and_value():
    cfg = mcts.MCTSConfig(hidden=16)
    params = _jax_params(cfg, seed=2)
    client = VariableClient(VariableServer(policy=_numpy(params)))
    actor = mcts.MCTSActor(_spec(), cfg, client, device=CPU)
    obs = Catch(seed=0).reset().observation
    priors, value = actor._evaluate(obs)
    device_params = actor._params
    actor._evaluate(obs)
    assert actor._params is device_params
    _, apply, _, _ = jax_mcts.make_network(_jax_spec(), cfg)
    logits, ref_value = apply(params, obs.reshape(1, -1))
    np.testing.assert_allclose(priors, np.asarray(jax.nn.softmax(logits[0])),
                               atol=1e-6)
    assert priors.dtype == np.float32 and isinstance(value, float)
    assert value == pytest.approx(float(ref_value[0]), abs=1e-6)


def test_actor_writes_search_probs_into_its_sequences():
    cfg = mcts.MCTSConfig(num_simulations=4, search_depth=4)
    table = replay.Table("t", 100, replay.Fifo(), replay.MinSize(1))
    client = VariableClient(VariableServer(policy=mcts.make_network(
        _spec(), cfg, CPU)[0](torch.Generator().manual_seed(0))))
    env = Catch(seed=0)
    actor = mcts.MCTSActor(_spec(), cfg, client,
                           adder=SequenceAdder(table, 10, period=10),
                           model_env=Catch(seed=0), seed=0, device=CPU)
    ts = env.reset()
    actor.observe_first(ts)
    while not ts.last():
        action = actor.select_action(ts.observation)
        ts = env.step(action)
        actor.observe(action, ts)
    assert table.size() == 1
    item = next(iter(table._items.values())).data
    assert item["search_probs"].shape == (10, 3)
    np.testing.assert_allclose(item["search_probs"][:9].sum(-1), 1.0,
                               rtol=1e-6)
    assert item["mask"].sum() == 9


# --------------------------------------------------------- VariableServer
def test_variable_server_matches_reference():
    port = VariableServer(policy=1, critic=2)
    ref = JaxVariableServer(policy=1, critic=2)
    for server in (port, ref):
        server.publish("extra", 3)
        server.publish("policy", 4)
    assert port.get_variables() == ref.get_variables() == [4, 2, 3]
    assert port.get_variables(("critic",)) == ref.get_variables(("critic",))
    assert port.get_variables(["extra", "policy"]) == [3, 4]
    with pytest.raises(KeyError):
        port.get_variables(("missing",))
    client = VariableClient(port, names=("policy",))
    assert client.params == 4


def test_variable_server_is_thread_safe():
    server = VariableServer()

    def publish(i):
        for j in range(200):
            server.publish(f"v{i}", j)
            server.get_variables()

    threads = [threading.Thread(target=publish, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert server.get_variables() == [199] * 4


# ----------------------------------------------------------------- builder
def test_builder_matches_reference_and_refuses_batched_acting():
    cfg = mcts.MCTSConfig(num_simulations=4, search_depth=4, batch_size=2,
                          min_replay_size=2)
    made = []

    def model_env(seed):
        made.append(seed)
        return Catch(seed=seed)

    port = mcts.MCTSBuilder(_spec(), model_env, cfg, seed=0, device=CPU)
    ref = jax_mcts.MCTSBuilder(_jax_spec(), lambda s: JaxCatch(seed=s), cfg,
                               seed=0)
    assert dataclasses.asdict(port.options) == \
        dataclasses.asdict(ref.options)
    table, ref_table = port.make_replay(), ref.make_replay()
    assert type(table.selector).__name__ == type(ref_table.selector).__name__
    assert table.rate_limiter.state_dict() == \
        ref_table.rate_limiter.state_dict()
    assert table.capacity == ref_table.capacity
    adder = port.make_adder(table)
    assert isinstance(adder, SequenceAdder)
    assert (adder.length, adder.period) == (10, 10)
    assert port.make_policy() is None and port.make_policy(True) is None
    learner = port.make_learner(iter(()))
    actor = port.make_actor(None, VariableClient(learner), adder, seed=7)
    assert isinstance(actor, mcts.MCTSActor) and made == [7]
    assert actor._model_env is not None and actor._device.type == "cpu"
    with pytest.raises(NotImplementedError, match="vectorized"):
        port.make_batched_actor(None, VariableClient(learner), [adder])
