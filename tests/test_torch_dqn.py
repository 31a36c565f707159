"""repro_torch DQN against the JAX package: the Q network's forward pass
with copied weights, the learner (loss, |td| priorities, gradients, params,
target params and Adam moments after 1 and 10 steps on the same replay
batches), greedy actions at epsilon 0, the exploration draws, the n-step
transition adder on the same TimeStep streams, and the builder's options
and replay.

Tolerances are stated where they are used: 1e-5 on f32 forward outputs,
losses and priorities of order 1; atol 1e-6 with rtol 1e-5 on the
learner's params and Adam moments after 1 and 10 steps (the same f32 math
in another summation order; the largest differences seen after 10 steps
are 3.9e-7 on params, 1.6e-9 on mu and 1.2e-7 on priorities); the adder's
transitions are equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import adders as jax_adders
from repro import replay as jax_replay
from repro.agents import dqn as jax_dqn
from repro.core import make_environment_spec as jax_spec
from repro.core import types as jax_types
from repro.envs import Catch as JaxCatch
from repro_torch import adders, replay, tree
from repro_torch.agents import dqn
from repro_torch.core import make_environment_spec, types
from repro_torch.envs import Catch

CPU = "cpu"
FWD_TOL = 1e-5
LEARNER_ATOL, LEARNER_RTOL = 1e-6, 1e-5
BATCH = 32

CONFIGS = {
    # the quickstart's learner: dueling, prioritized, n-step 1
    "quickstart": dict(min_replay_size=50, samples_per_insert=0.0,
                       batch_size=BATCH, n_step=1, epsilon=0.2),
    # DQNConfig() defaults but the batch, and a target copy every 4 steps
    "defaults": dict(batch_size=BATCH, target_update_period=4),
    "plain": dict(batch_size=BATCH, dueling=False, prioritized=False,
                  target_update_period=3),
}


def _spec():
    return make_environment_spec(Catch(seed=0))


def _jax_params(cfg, seed=0):
    init, *_ = jax_dqn.make_q_network(jax_spec(JaxCatch(seed=0)), cfg)
    return init(jax.random.key(seed))


def _to_torch(params):
    return tree.map(lambda x: torch.as_tensor(np.array(x, np.float32)),
                    params)


def _boards(n, rng):
    """n Catch-like boards: a ball somewhere, the paddle on the last row."""
    obs = np.zeros((n, 10, 5), np.float32)
    obs[np.arange(n), rng.randint(0, 9, n), rng.randint(0, 5, n)] = 1.0
    obs[np.arange(n), 9, rng.randint(0, 5, n)] = 1.0
    return obs


def _transitions(seed, n=BATCH):
    """A replay batch as the n-step adder writes it: boards, actions,
    n-step rewards and discounts (0 past an episode's end), and sampling
    probabilities for the importance weights."""
    rng = np.random.RandomState(seed)
    ended = rng.rand(n) < 0.3
    fields = (_boards(n, rng), rng.randint(0, 3, n).astype(np.int32),
              np.where(ended, rng.choice([-1.0, 1.0], n), 0.0
                       ).astype(np.float32),
              np.where(ended, 0.0, 0.99 ** rng.randint(1, 4, n)
                       ).astype(np.float32),
              _boards(n, rng), ())
    probs = rng.rand(n) * 0.01 + 1e-4
    return fields, np.arange(n, dtype=np.int64) + seed * n, probs


def _samples(steps, port):
    for i in range(steps):
        fields, keys, probs = _transitions(i)
        if port:
            yield replay.ReplaySample(replay.SampleInfo(keys, probs),
                                      types.Transition(*fields))
        else:
            yield jax_replay.ReplaySample(jax_replay.SampleInfo(keys, probs),
                                          jax_types.Transition(*fields))


def _assert_tree_close(port, ref, atol, rtol):
    port_leaves = [np.asarray(x) for x in tree.leaves(port)]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(port_leaves) == len(ref_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


# ------------------------------------------------------------------ network
@pytest.mark.parametrize("dueling", [True, False])
def test_q_network_matches_reference_with_copied_params(dueling):
    cfg = dqn.DQNConfig(dueling=dueling)
    params = _jax_params(cfg, seed=3)
    obs = _boards(7, np.random.RandomState(0)).reshape(7, -1)
    _, apply, _, _ = jax_dqn.make_q_network(jax_spec(JaxCatch()), cfg)
    _, port_apply, _, _ = dqn.make_q_network(_spec(), cfg, device=CPU)
    np.testing.assert_allclose(
        port_apply(_to_torch(params), torch.as_tensor(obs)).numpy(),
        np.asarray(apply(params, obs)), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("dueling", [True, False])
def test_q_network_init_has_the_reference_leaves(dueling):
    cfg = dqn.DQNConfig(dueling=dueling)
    init, *_ = dqn.make_q_network(_spec(), cfg, device=CPU)
    params = init(torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in tree.leaves(params)] == \
        [x.shape for x in jax.tree.leaves(_jax_params(cfg))]
    again = init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(params),
                                                  tree.leaves(again)))


# ------------------------------------------------------------------ learner
def _learners(cfg, steps):
    ref_priorities, port_priorities = [], []
    ref = jax_dqn.make_learner(
        jax_spec(JaxCatch()), cfg, _samples(steps, port=False),
        jax.random.key(0),
        priority_update_cb=lambda k, p: ref_priorities.append((k, p)))
    port = dqn.make_learner(
        _spec(), cfg, _samples(steps, port=True),
        torch.Generator().manual_seed(0),
        priority_update_cb=lambda k, p: port_priorities.append((k, p)),
        device=CPU)
    params = _to_torch(ref.state.params)
    port.state = port.state._replace(
        params=params, target_params=_to_torch(ref.state.target_params))
    return ref, port, ref_priorities, port_priorities


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("name", CONFIGS)
def test_learner_steps_match_reference(name, steps):
    """Double DQN with importance weights: the loss and the |td| priorities
    of every step, then the params, the target params and Adam's step, mu
    and nu.  After the first step mu = (1 - b1) g, so it checks the
    (clipped) gradients leaf for leaf, and nu = (1 - b2) g^2 their
    squares."""
    cfg = dqn.DQNConfig(**CONFIGS[name])
    ref, port, ref_prio, port_prio = _learners(cfg, steps)
    for _ in range(steps):
        ref_metrics, port_metrics = ref.step(), port.step()
        np.testing.assert_allclose(port_metrics["loss"], ref_metrics["loss"],
                                   atol=FWD_TOL, rtol=FWD_TOL)
        assert port_metrics["learner_steps"] == ref_metrics["learner_steps"]
    assert len(port_prio) == len(ref_prio) == (steps if cfg.prioritized
                                               else 0)
    for (keys, prio), (ref_keys, ref_p) in zip(port_prio, ref_prio):
        np.testing.assert_array_equal(keys, ref_keys)
        np.testing.assert_allclose(prio, ref_p, atol=FWD_TOL, rtol=FWD_TOL)
    state, ref_state = port.state, ref.state
    _assert_tree_close(state.params, ref_state.params, LEARNER_ATOL,
                       LEARNER_RTOL)
    _assert_tree_close(state.target_params, ref_state.target_params,
                       LEARNER_ATOL, LEARNER_RTOL)
    opt, ref_opt = state.opt_state, ref_state.opt_state
    assert int(opt.step) == int(ref_opt.step) == steps
    if steps == 1:
        _assert_tree_close(tree.map(lambda m: m / 0.1, opt.mu),
                           jax.tree.map(lambda m: m / 0.1, ref_opt.mu),
                           FWD_TOL, FWD_TOL)
    _assert_tree_close(opt.mu, ref_opt.mu, LEARNER_ATOL, LEARNER_RTOL)
    _assert_tree_close(opt.nu, ref_opt.nu, LEARNER_ATOL, LEARNER_RTOL)
    assert int(state.steps) == int(ref_state.steps) == steps
    assert state.steps.dtype == torch.int32


def test_target_network_copies_on_its_period_and_never_aliases():
    cfg = dqn.DQNConfig(batch_size=BATCH, target_update_period=2)
    _, port, _, _ = _learners(cfg, 3)
    port.step()
    assert not any(torch.equal(a, b) for a, b in zip(
        tree.leaves(port.state.params),
        tree.leaves(port.state.target_params)) if a.dim() == 2)
    port.step()                                    # step 2 copies
    for a, b in zip(tree.leaves(port.state.params),
                    tree.leaves(port.state.target_params)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_learner_step_reports_loss_and_counter_in_one_copy():
    cfg = dqn.DQNConfig(**CONFIGS["quickstart"])
    _, port, _, prio = _learners(cfg, 2)
    metrics = port.step()
    assert set(metrics) == {"loss", "learner_steps", "learner_walltime"}
    assert all(isinstance(v, float) for v in metrics.values())
    (keys, priorities), = prio
    assert priorities.shape == (BATCH,) and (priorities >= 0).all()


# ------------------------------------------------------------------- policy
def _catch_observations(n, seed):
    env, rng, obs = Catch(seed=seed), np.random.RandomState(seed), []
    ts = env.reset()
    while len(obs) < n:
        obs.append(ts.observation)
        ts = env.reset() if ts.last() else env.step(rng.randint(3))
    return np.stack(obs)


@pytest.mark.parametrize("dueling", [True, False])
def test_greedy_actions_match_reference_at_epsilon_zero(dueling):
    cfg = dqn.DQNConfig(dueling=dueling, epsilon=0.0)
    params = _jax_params(cfg, seed=4)
    obs = _catch_observations(60, seed=1)
    ref_policy = jax_dqn.make_eval_policy(jax_spec(JaxCatch()), cfg)
    actions = dqn.make_eval_policy(_spec(), cfg)(
        _to_torch(params), torch.Generator().manual_seed(0),
        torch.as_tensor(obs))
    assert actions.dtype == torch.int32 and actions.shape == (60,)
    expected = [int(ref_policy(params, jax.random.key(i), jnp.asarray(o)))
                for i, o in enumerate(obs)]
    assert actions.tolist() == expected
    assert len(set(expected)) > 1


def test_greedy_ties_take_the_first_maximum_like_the_reference():
    cfg = dqn.DQNConfig(epsilon=0.0)
    params = jax.tree.map(jnp.zeros_like, _jax_params(cfg))
    obs = _catch_observations(4, seed=2)
    ref_policy = jax_dqn.make_behavior_policy(jax_spec(JaxCatch()), cfg)
    actions = dqn.make_behavior_policy(_spec(), cfg)(
        _to_torch(params), torch.Generator(), torch.as_tensor(obs))
    assert actions.tolist() == [0] * 4 == [
        int(ref_policy(params, jax.random.key(0), jnp.asarray(o)))
        for o in obs]


@pytest.mark.parametrize("eps", [1.0, 0.2])
def test_exploration_draws_are_independent_of_each_other(eps):
    """The random action and the explore coin are two independent draws:
    at fixed Q, each non-greedy action comes up eps / A of the time and
    the greedy one 1 - eps + eps / A (20000 draws, within 0.015, over 5
    standard deviations)."""
    cfg = dqn.DQNConfig()
    params = _to_torch(_jax_params(cfg, seed=5))
    obs = torch.as_tensor(_catch_observations(1, seed=3)).expand(
        20000, 10, 5)
    policy = dqn.make_behavior_policy(_spec(), cfg, epsilon=eps)
    greedy = int(dqn.make_eval_policy(_spec(), cfg)(
        params, torch.Generator(), obs[:1])[0])
    actions = policy(params, torch.Generator().manual_seed(0), obs)
    freq = np.bincount(actions.numpy(), minlength=3) / 20000
    expected = np.full(3, eps / 3)
    expected[greedy] += 1 - eps
    np.testing.assert_allclose(freq, expected, atol=0.015)


# -------------------------------------------------------------------- adder
def _timestep_stream(pkg, seed):
    """Episodes of random length (1 to 7 steps) with random rewards,
    discounts below 1, and both terminations and truncations."""
    rng = np.random.RandomState(seed)
    stream = []
    for _ in range(6):
        stream.append(("first", pkg.restart(rng.rand(4).astype(np.float32))))
        length = rng.randint(1, 8)
        for t in range(length):
            obs = rng.rand(4).astype(np.float32)
            reward, action = float(rng.randn()), np.int32(rng.randint(3))
            if t < length - 1:
                ts = pkg.transition(reward, obs, discount=rng.uniform(0.5, 1))
            elif rng.rand() < 0.5:
                ts = pkg.termination(reward, obs)
            else:
                ts = pkg.truncation(reward, obs, discount=0.9)
            stream.append((action, ts))
    return stream


def _drive(adder, stream):
    for action, ts in stream:
        if isinstance(action, str):
            adder.add_first(ts)
        else:
            adder.add(action, ts)


@pytest.mark.parametrize("n_step", [1, 3, 5])
def test_nstep_adder_matches_reference(n_step):
    """The same TimeStep stream yields equal transitions (observations,
    action, n-step reward and discount, next observation) with equal
    priorities, in the same order."""
    port_table = replay.Table("t", 1000, replay.Fifo(), replay.MinSize(1))
    ref_table = jax_replay.Table("t", 1000, jax_replay.Fifo(),
                                 jax_replay.MinSize(1))
    _drive(adders.NStepTransitionAdder(port_table, n_step, 0.97,
                                       priority=100.0),
           _timestep_stream(types, seed=n_step))
    _drive(jax_adders.NStepTransitionAdder(ref_table, n_step, 0.97,
                                           priority=100.0),
           _timestep_stream(jax_types, seed=n_step))
    port_items = port_table.state_dict()["items"]
    ref_items = ref_table.state_dict()["items"]
    assert len(port_items) == len(ref_items) > 10
    for (key, item, prio), (ref_key, ref_item, ref_prio) in zip(
            port_items, ref_items):
        assert (key, prio) == (ref_key, ref_prio)
        assert type(item).__name__ == "Transition"
        for a, b in zip(item, ref_item):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_nstep_adder_requires_add_first():
    adder = adders.NStepTransitionAdder(
        replay.Table("t", 10, replay.Fifo(), replay.MinSize(1)), 3)
    with pytest.raises(RuntimeError, match="add_first"):
        adder.add(0, types.transition(0.0, np.zeros(2)))
    transition = adders.TransitionAdder(
        replay.Table("t", 10, replay.Fifo(), replay.MinSize(1)))
    assert transition.n == 1


# ------------------------------------------------------------------ builder
@pytest.mark.parametrize("kwargs", [
    {}, CONFIGS["quickstart"], dict(samples_per_insert=2.0, batch_size=8),
    dict(prioritized=False)])
def test_builder_options_and_replay_match_reference(kwargs):
    import dataclasses
    cfg = dqn.DQNConfig(**kwargs)
    port = dqn.DQNBuilder(_spec(), cfg, seed=2, device=CPU)
    ref = jax_dqn.DQNBuilder(jax_spec(JaxCatch()),
                             jax_dqn.DQNConfig(**kwargs), seed=2)
    assert dataclasses.asdict(port.options) == \
        dataclasses.asdict(ref.options)
    table, ref_table = port.make_replay(), ref.make_replay()
    assert type(table.selector).__name__ == type(ref_table.selector).__name__
    limiter, ref_limiter = table.rate_limiter, ref_table.rate_limiter
    assert type(limiter).__name__ == type(ref_limiter).__name__
    assert limiter.state_dict() == ref_limiter.state_dict()
    assert table.capacity == ref_table.capacity
    assert isinstance(port.make_adder(table), adders.NStepTransitionAdder)
