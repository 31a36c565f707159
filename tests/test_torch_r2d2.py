"""repro_torch's recurrent and demonstration agents against the JAX
package: the LSTM core and network with copied weights, the recurrent
actors at epsilon 0 (and the numpy state they hand their adder), the R2D2
and R2D3 learners and the DQfD learner after 1 and 10 steps on the same
batches, ``mixed_iterator``'s batches from the same tables, the demo
generators, and the builders' options and replay.

Tolerances, stated where used: 1e-5 on forward outputs, losses and
priorities of order 1; atol 1e-6 with rtol 1e-5 on Adam's moments after 1
and 10 steps (the same f32 math in another summation order); atol 1e-5
(1% of one Adam step at the learning rate 1e-3) with rtol 1e-5 on params
and target params: a gradient below Adam's eps (1e-8), as some LSTM input
weights get (~1e-9), moves its weight by lr g / (|g| + eps), which turns
the summation-order noise in g into differences of up to 6e-6 after one
step; batches, demos and actions equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import replay as jax_replay
from repro.adders.sequence import SequenceAdder as JaxSequenceAdder
from repro.agents import dqfd as jax_dqfd
from repro.agents import r2d2 as jax_r2d2
from repro.agents import r2d3 as jax_r2d3
from repro.core import RecurrentActor as JaxRecurrentActor
from repro.core import BatchedRecurrentActor as JaxBatchedRecurrentActor
from repro.core import make_environment_spec as jax_spec
from repro.core.variable import VariableClient as JaxVariableClient
from repro.envs import DeepSea as JaxDeepSea
from repro.envs import MemoryChain as JaxMemoryChain
from repro.networks import lstm as jax_lstm
from repro_torch import replay, tree
from repro_torch.adders.sequence import SequenceAdder
from repro_torch.agents import dqfd, r2d2, r2d3
from repro_torch.core import (BatchedRecurrentActor, RecurrentActor,
                              VariableClient, make_environment_spec)
from repro_torch.envs import DeepSea, MemoryChain
from repro_torch.networks import lstm

CPU = "cpu"
FWD_TOL = 1e-5
LEARNER_ATOL, LEARNER_RTOL = 1e-6, 1e-5
PARAM_ATOL = 1e-5


def _to_torch(params):
    return lstm.params_from_jax(jax.tree.map(np.asarray, params), CPU)


def _assert_tree_close(port, ref, atol, rtol):
    port_leaves = [np.asarray(x) for x in tree.leaves(port)]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(port_leaves) == len(ref_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


# --------------------------------------------------------------------- LSTM
@pytest.mark.parametrize("in_dim,hidden,batch", [(3, 8, 1), (16, 32, 5)])
def test_lstm_apply_and_unroll_match_reference(in_dim, hidden, batch):
    """One step and a 7-step unroll from a non-zero state: outputs and the
    final (h, c), with the reference's gate order i, g, f, o."""
    jparams = jax_lstm.lstm_init(jax.random.key(1), in_dim, hidden)
    params = _to_torch(jparams)
    rng = np.random.RandomState(0)
    xs = rng.randn(7, batch, in_dim).astype(np.float32)
    h0, c0 = (rng.randn(batch, hidden).astype(np.float32) for _ in range(2))
    state = lstm.LSTMState(torch.as_tensor(h0), torch.as_tensor(c0))
    jstate = jax_lstm.LSTMState(jnp.asarray(h0), jnp.asarray(c0))

    out, new = lstm.lstm_apply(params, torch.as_tensor(xs[0]), state)
    jout, jnew = jax_lstm.lstm_apply(jparams, jnp.asarray(xs[0]), jstate)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(new.c.numpy(), np.asarray(jnew.c),
                               atol=FWD_TOL, rtol=FWD_TOL)

    outs, final = lstm.lstm_unroll(params, torch.as_tensor(xs), state)
    jouts, jfinal = jax_lstm.lstm_unroll(jparams, jnp.asarray(xs), jstate)
    assert outs.shape == (7, batch, hidden)
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for a, b in zip(final, jfinal):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_TOL,
                                   rtol=FWD_TOL)


def test_lstm_network_matches_reference_with_copied_params():
    net = lstm.LSTMNetwork((16,), 8, 3)
    jnet = jax_lstm.LSTMNetwork((16,), 8, 3)
    jparams = jnet.init(jax.random.key(2), 5)
    params = _to_torch(jparams)
    obs = np.random.RandomState(1).randn(6, 4, 5).astype(np.float32)
    q, final = net.unroll(params, torch.as_tensor(obs),
                          net.initial_state(4, device=CPU))
    jq, jfinal = jnet.unroll(jparams, jnp.asarray(obs), jnet.initial_state(4))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=FWD_TOL,
                               rtol=FWD_TOL)
    q1, _ = net.apply(params, torch.as_tensor(obs[0]),
                      net.initial_state(4, device=CPU))
    jq1, _ = jnet.apply(jparams, jnp.asarray(obs[0]), jnet.initial_state(4))
    np.testing.assert_allclose(q1.numpy(), np.asarray(jq1), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_lstm_network_init_has_the_reference_leaves():
    params = lstm.LSTMNetwork((16,), 8, 3).init(
        torch.Generator().manual_seed(0), 5, device=CPU)
    jparams = jax_lstm.LSTMNetwork((16,), 8, 3).init(jax.random.key(0), 5)
    flat, _ = tree.flatten(params)
    jflat = jax.tree.leaves(jparams)
    assert [tuple(x.shape) for x in flat] == [x.shape for x in jflat]
    assert [x.dtype for x in flat] == [torch.float32] * len(flat)
    # the JAX order: head, lstm (b, wh, wi), torso
    assert tuple(params["lstm"]["b"].shape) == (32,)
    assert float(params["lstm"]["b"].abs().sum()) == 0.0


# ------------------------------------------------------------------- actors
class _Static:
    def __init__(self, params):
        self.params = params

    def get_variables(self, names=("policy",)):
        return [self.params for _ in names]


def _memory_chain_pair(cfg):
    spec = make_environment_spec(MemoryChain(memory_length=5, seed=0))
    jspec = jax_spec(JaxMemoryChain(memory_length=5, seed=0))
    jnet = jax_r2d2.make_network(jspec, cfg)
    jparams = jnet.init(jax.random.key(4), jnet.in_dim)
    return spec, jspec, jnet, jparams


def test_recurrent_actor_greedy_actions_match_reference():
    """Epsilon 0: the same actions over four MemoryChain episodes, the core
    state carried across steps and reset at each episode's start; the
    sequence adder gets the start state as numpy extras, as the
    reference's does."""
    cfg = r2d2.R2D2Config(hidden=16, lstm_size=8, epsilon=0.0)
    spec, jspec, jnet, jparams = _memory_chain_pair(cfg)
    table = replay.Table("t", 100, replay.Uniform(0), replay.MinSize(1))
    jtable = jax_replay.Table("t", 100, jax_replay.Uniform(0),
                              jax_replay.MinSize(1))
    net = r2d2.make_network(spec, cfg)
    actor = RecurrentActor(
        r2d2.make_behavior_policy(spec, cfg), lambda: net.initial_state(
            1, device=CPU), VariableClient(_Static(jax.tree.map(
                np.asarray, jparams))), SequenceAdder(table, 3, 2),
        device=CPU)
    jactor = JaxRecurrentActor(
        jax_r2d2.make_behavior_policy(jspec, cfg),
        lambda: jnet.initial_state(1), JaxVariableClient(_Static(jparams)),
        JaxSequenceAdder(jtable, 3, 2))
    env, jenv = MemoryChain(5, seed=1), JaxMemoryChain(5, seed=1)
    actions = []
    for _ in range(4):
        ts, jts = env.reset(), jenv.reset()
        actor.observe_first(ts)
        jactor.observe_first(jts)
        extras, jextras = (actor._adder._start_extras,
                           jactor._adder._start_extras)
        assert type(extras).__name__ == "LSTMState"
        for a, b in zip(extras, jextras):
            assert isinstance(a, np.ndarray) and a.shape == b.shape == (1, 8)
            np.testing.assert_array_equal(a, b)
        while not ts.last():
            a, b = actor.select_action(ts.observation), \
                jactor.select_action(jts.observation)
            assert a == b and a.dtype == np.int32
            for x, y in zip(actor._state, jactor._state):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           atol=FWD_TOL, rtol=FWD_TOL)
            actions.append(int(a))
            ts, jts = env.step(a), jenv.step(b)
            actor.observe(a, ts)
            jactor.observe(b, jts)
    assert table.size() == jtable.size() > 0
    assert len(actions) == 20


def test_batched_recurrent_actor_greedy_actions_match_reference():
    """Three MemoryChain envs of different memory lengths through one call
    a step; each env's row resets on its own episode start."""
    cfg = r2d2.R2D2Config(hidden=16, lstm_size=8, epsilon=0.0)
    spec, jspec, jnet, jparams = _memory_chain_pair(cfg)
    net = r2d2.make_network(spec, cfg)
    actor = BatchedRecurrentActor(
        r2d2.make_behavior_policy(spec, cfg),
        lambda: net.initial_state(1, device=CPU),
        VariableClient(_Static(jax.tree.map(np.asarray, jparams))),
        device=CPU)
    jactor = JaxBatchedRecurrentActor(
        jax_r2d2.make_behavior_policy(jspec, cfg),
        lambda: jnet.initial_state(1), JaxVariableClient(_Static(jparams)))
    envs = [MemoryChain(n, seed=n) for n in (5, 3, 4)]
    steps = [env.reset() for env in envs]
    for i, ts in enumerate(steps):
        actor.observe_first(ts, env_id=i)
        jactor.observe_first(ts, env_id=i)
    resets = 0
    for _ in range(14):
        obs = np.stack([ts.observation for ts in steps])
        a, b = actor.select_action(obs), jactor.select_action(obs)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(actor._state.h.numpy(),
                                   np.asarray(jactor._state.h)[:, 0],
                                   atol=FWD_TOL, rtol=FWD_TOL)
        for i, env in enumerate(envs):
            steps[i] = env.step(a[i])
            if steps[i].last():
                steps[i] = env.reset()
                actor.observe_first(steps[i], env_id=i)
                jactor.observe_first(steps[i], env_id=i)
                resets += 1
    assert resets >= 6


def test_behavior_policy_explores_with_two_independent_draws():
    """At epsilon 1 every action is the random draw; the draws repeat for a
    repeated (seed, step) and cover every action."""
    cfg = r2d2.R2D2Config(hidden=16, lstm_size=8)
    spec, _, jnet, jparams = _memory_chain_pair(cfg)
    policy = r2d2.make_behavior_policy(spec, cfg, epsilon=1.0)
    params = _to_torch(jparams)
    obs = torch.zeros((64, 3))
    state = r2d2.make_network(spec, cfg).initial_state(64, device=CPU)
    draws = [policy(params, torch.Generator().manual_seed(s), obs, state)[0]
             for s in (3, 3, 4)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert set(draws[0].tolist()) == {0, 1}


# ----------------------------------------------------------------- learners
def _sequences(seed, batch, T, obs_shape, num_actions):
    """A batch of replayed sequences as the SequenceAdder writes them:
    observations, actions, rewards, discounts (0 after an episode's end),
    the start-of-episode flags and the padding mask."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(2, T + 1, batch)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    ended = rng.rand(batch) < 0.5
    discount = mask.copy()
    discount[np.arange(batch), lengths - 1] = np.where(ended, 0.0, 1.0)
    starts = np.zeros((batch, T), bool)
    starts[:, 0] = rng.rand(batch) < 0.5
    return {
        "observation": (rng.randn(batch, T, *obs_shape) * mask.reshape(
            batch, T, *([1] * len(obs_shape)))).astype(np.float32),
        "action": (rng.randint(0, num_actions, (batch, T)) * mask
                   ).astype(np.int32),
        "reward": (rng.choice([-1.0, 0.0, 1.0], (batch, T)) * mask
                   ).astype(np.float32),
        "discount": discount.astype(np.float32),
        "start_of_episode": starts,
        "mask": mask,
    }


def _samples(steps, batch, T, obs_shape, num_actions, port):
    for i in range(steps):
        data = _sequences(i, batch, T, obs_shape, num_actions)
        rng = np.random.RandomState(100 + i)
        keys = np.arange(batch, dtype=np.int64) + i * batch
        probs = rng.rand(batch) * 0.01 + 1e-4
        lib = replay if port else jax_replay
        yield lib.ReplaySample(lib.SampleInfo(keys, probs), data)


R2D2_CASES = {
    # the acceptance's learner: no burn-in, T 6
    "memory": dict(sequence_length=6, period=3, burn_in=0, batch_size=16,
                   target_update_period=4),
    # R2D2Config() defaults: burn-in 4 of T 16, and a target copy every 3
    "burn_in": dict(batch_size=8, target_update_period=3),
}


def _r2d2_learners(cfg, steps, env=("memory", 5)):
    name, arg = env
    if name == "memory":
        spec = make_environment_spec(MemoryChain(arg, seed=0))
        jspec = jax_spec(JaxMemoryChain(arg, seed=0))
    else:
        spec = make_environment_spec(DeepSea(arg, seed=0))
        jspec = jax_spec(JaxDeepSea(arg, seed=0))
    shape, actions = spec.observations.shape, spec.actions.num_values
    ref_prio, port_prio = [], []
    T = cfg.sequence_length
    ref = jax_r2d2.make_learner(
        jspec, cfg, _samples(steps, cfg.batch_size, T, shape, actions, False),
        jax.random.key(0),
        priority_update_cb=lambda k, p: ref_prio.append((k, p)))
    port = r2d2.make_learner(
        spec, cfg, _samples(steps, cfg.batch_size, T, shape, actions, True),
        torch.Generator().manual_seed(0),
        priority_update_cb=lambda k, p: port_prio.append((k, p)), device=CPU)
    port.state = port.state._replace(
        params=_to_torch(ref.state.params),
        target_params=_to_torch(ref.state.target_params))
    return ref, port, ref_prio, port_prio


def _assert_learners_match(ref, port, ref_prio, port_prio, steps):
    for _ in range(steps):
        ref_metrics, port_metrics = ref.step(), port.step()
        np.testing.assert_allclose(port_metrics["loss"], ref_metrics["loss"],
                                   atol=FWD_TOL, rtol=FWD_TOL)
        assert port_metrics["learner_steps"] == ref_metrics["learner_steps"]
    assert len(port_prio) == len(ref_prio) == steps
    for (keys, prio), (ref_keys, ref_p) in zip(port_prio, ref_prio):
        np.testing.assert_array_equal(keys, ref_keys)
        np.testing.assert_allclose(prio, np.asarray(ref_p), atol=FWD_TOL,
                                   rtol=FWD_TOL)
    state, ref_state = port.state, ref.state
    for a, b in ((state.params, ref_state.params),
                 (state.target_params, ref_state.target_params)):
        _assert_tree_close(a, b, PARAM_ATOL, LEARNER_RTOL)
    for a, b in ((state.opt_state.mu, ref_state.opt_state.mu),
                 (state.opt_state.nu, ref_state.opt_state.nu)):
        _assert_tree_close(a, b, LEARNER_ATOL, LEARNER_RTOL)
    assert int(state.opt_state.step) == int(ref_state.opt_state.step)
    assert int(state.steps) == int(ref_state.steps) == steps
    assert state.steps.dtype == torch.int32


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("name", R2D2_CASES)
def test_r2d2_learner_steps_match_reference(name, steps):
    """Burn-in warm-up without gradient for both param sets, double-Q
    targets within the sequence, the importance-weighted loss over the
    mask, the max/mean |td| priority mix, Adam with clip 40 and the
    periodic target copy: loss and priorities every step, then params,
    target params and Adam's state."""
    cfg = r2d2.R2D2Config(**R2D2_CASES[name])
    _assert_learners_match(*_r2d2_learners(cfg, steps), steps)


@pytest.mark.parametrize("steps", [1, 10])
def test_r2d3_learner_steps_match_reference(steps):
    """R2D3's learner is R2D2's on DeepSea sequences (the acceptance's
    config), with demo rows (key -1) left out of the priority updates."""
    cfg = r2d3.R2D3Config(sequence_length=5, period=4, burn_in=0,
                          batch_size=16, target_update_period=4,
                          demo_ratio=0.5)
    ref, port, ref_prio, port_prio = _r2d2_learners(cfg, steps, ("sea", 5))
    _assert_learners_match(ref, port, ref_prio, port_prio, steps)


# ------------------------------------------------------------ demonstrations
def test_deep_sea_demos_equal_reference():
    demos = dqfd.generate_deep_sea_demos(DeepSea(size=6, seed=1), 20)
    jdemos = jax_dqfd.generate_deep_sea_demos(JaxDeepSea(size=6, seed=1), 20)
    assert len(demos) == len(jdemos) == 120
    for a, b in zip(demos, jdemos):
        assert type(a).__name__ == type(b).__name__ == "Transition"
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    partial = dqfd.generate_deep_sea_demos(DeepSea(size=4, seed=2), 10,
                                           success_rate=0.5, n_step=2,
                                           discount=0.9, seed=3)
    jpartial = jax_dqfd.generate_deep_sea_demos(JaxDeepSea(size=4, seed=2),
                                                10, success_rate=0.5,
                                                n_step=2, discount=0.9,
                                                seed=3)
    for a, b in zip(partial, jpartial):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_sequence_demos_equal_reference():
    demos = dqfd.generate_sequence_demos(
        DeepSea(size=5, seed=1), lambda e: e.optimal_action(), 15, 5, 4)
    jdemos = jax_dqfd.generate_sequence_demos(
        JaxDeepSea(size=5, seed=1), lambda e: e.optimal_action(), 15, 5, 4)
    assert len(demos) == len(jdemos) > 0
    for a, b in zip(demos, jdemos):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype


def _filled_tables(lib, demos, items, seed):
    """An agent table (prioritized, priorities from ``seed``) and the
    builder's demo table over the same items."""
    agent = lib.Table("replay", 1000, lib.Prioritized(), lib.MinSize(1))
    rng = np.random.RandomState(seed)
    for item in items:
        agent.insert(item, priority=float(rng.rand() * 5 + 0.1))
    demo = lib.Table("demos", len(demos), lib.Prioritized(), lib.MinSize(1))
    for item in demos:
        demo.insert(item, priority=1.0)
    return agent, demo


@pytest.mark.parametrize("batch,ratio", [(32, 0.5), (16, 0.25), (8, 0.01)])
def test_mixed_iterator_batches_equal_reference(batch, ratio):
    """The same tables give the same batches: demo rows first (keys -1),
    then agent rows, with equal probabilities and data."""
    demos = dqfd.generate_deep_sea_demos(DeepSea(size=6, seed=1), 5)
    items = dqfd.generate_deep_sea_demos(DeepSea(size=6, seed=2), 12,
                                         success_rate=0.3, seed=5)
    agent, demo = _filled_tables(replay, demos, items, 0)
    jagent, jdemo = _filled_tables(jax_replay, demos, items, 0)
    ours = dqfd.mixed_iterator(agent, demo, batch, ratio)
    theirs = jax_dqfd.mixed_iterator(jagent, jdemo, batch, ratio)
    n_demo = max(int(round(ratio * batch)), 1)
    for _ in range(5):
        a, b = next(ours), next(theirs)
        np.testing.assert_array_equal(a.info.keys, b.info.keys)
        assert (a.info.keys[:n_demo] == -1).all()
        assert (a.info.keys[n_demo:] >= 0).all()
        np.testing.assert_array_equal(a.info.probabilities,
                                      b.info.probabilities)
        assert a.info.probabilities.dtype == b.info.probabilities.dtype
        for x, y in zip(tree.leaves(a.data), jax.tree.leaves(b.data)):
            np.testing.assert_array_equal(x, np.asarray(y))
            assert x.dtype == np.asarray(y).dtype


@pytest.mark.parametrize("steps", [1, 10])
def test_dqfd_learner_steps_match_reference(steps):
    """DQfD on the builders' own datasets: mixed batches from equal tables
    through the DQN learner, priorities sent for agent rows only, after
    1 and 10 steps."""
    demos = dqfd.generate_deep_sea_demos(DeepSea(size=6, seed=1), 5)
    items = dqfd.generate_deep_sea_demos(DeepSea(size=6, seed=2), 12,
                                         success_rate=0.3, seed=5)
    cfg = dqfd.DQfDConfig(batch_size=16, n_step=1, demo_ratio=0.5,
                          target_update_period=4)
    spec = make_environment_spec(DeepSea(size=6, seed=1))
    jspec = jax_spec(JaxDeepSea(size=6, seed=1))
    builder = dqfd.DQfDBuilder(spec, demos, cfg, seed=0, device=CPU)
    jbuilder = jax_dqfd.DQfDBuilder(jspec, demos, cfg, seed=0)
    agent, _ = _filled_tables(replay, demos, items, 0)
    jagent, _ = _filled_tables(jax_replay, demos, items, 0)
    sent, jsent = [], []
    port = builder.make_learner(builder.make_dataset(agent),
                                lambda k, p: sent.append((k, p)))
    ref = jbuilder.make_learner(jbuilder.make_dataset(jagent),
                                lambda k, p: jsent.append((k, p)))
    port.state = port.state._replace(
        params=_to_torch(ref.state.params),
        target_params=_to_torch(ref.state.target_params))
    _assert_learners_match(ref, port, jsent, sent, steps)
    for keys, prio in sent:
        assert len(keys) == len(prio) == 8 and (keys >= 0).all()


# ----------------------------------------------------------------- builders
def _builder_pairs():
    mem = (MemoryChain(5, seed=0), JaxMemoryChain(5, seed=0))
    sea = (DeepSea(4, seed=0), JaxDeepSea(4, seed=0))
    demos = dqfd.generate_deep_sea_demos(DeepSea(size=4, seed=0), 4)
    seqs = dqfd.generate_sequence_demos(DeepSea(size=4, seed=0),
                                        lambda e: e.optimal_action(), 4, 4, 3)
    spi = dict(samples_per_insert=2.0)
    return {
        "r2d2": (lambda s: r2d2.R2D2Builder(s, r2d2.R2D2Config(**spi),
                                            device=CPU),
                 lambda s: jax_r2d2.R2D2Builder(s, jax_r2d2.R2D2Config(
                     **spi)), mem),
        "r2d2_minsize": (lambda s: r2d2.R2D2Builder(
            s, r2d2.R2D2Config(samples_per_insert=0.0), device=CPU),
            lambda s: jax_r2d2.R2D2Builder(
                s, jax_r2d2.R2D2Config(samples_per_insert=0.0)), mem),
        "r2d3": (lambda s: r2d3.R2D3Builder(s, seqs, device=CPU),
                 lambda s: jax_r2d3.R2D3Builder(s, seqs), sea),
        "dqfd": (lambda s: dqfd.DQfDBuilder(s, demos, device=CPU),
                 lambda s: jax_dqfd.DQfDBuilder(s, demos), sea),
    }


@pytest.mark.parametrize("name", ["r2d2", "r2d2_minsize", "r2d3", "dqfd"])
def test_builder_options_and_replay_match_reference(name):
    port_fn, ref_fn, (env, jenv) = _builder_pairs()[name]
    builder = port_fn(make_environment_spec(env))
    jbuilder = ref_fn(jax_spec(jenv))
    assert dataclasses.asdict(builder.options) == \
        dataclasses.asdict(jbuilder.options)
    assert dataclasses.asdict(builder.cfg) == dataclasses.asdict(jbuilder.cfg)
    table, jtable = builder.make_replay(), jbuilder.make_replay()
    assert (table.capacity, type(table.selector).__name__,
            type(table.rate_limiter).__name__) == \
        (jtable.capacity, type(jtable.selector).__name__,
         type(jtable.rate_limiter).__name__)
    assert vars(table.rate_limiter).keys() == vars(jtable.rate_limiter).keys()
    for key, value in vars(jtable.rate_limiter).items():
        if isinstance(value, (int, float)):
            assert getattr(table.rate_limiter, key) == value, key
    adder, jadder = builder.make_adder(table), jbuilder.make_adder(jtable)
    assert type(adder).__name__ == type(jadder).__name__
    if hasattr(builder, "make_demo_table"):
        demo, jdemo = builder.make_demo_table(), jbuilder.make_demo_table()
        assert demo.size() == jdemo.size() > 0
