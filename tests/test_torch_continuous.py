"""repro_torch's continuous-control agents against the JAX package: the C51
projection ``l2_project`` (the reference's four cases of
``tests/test_distributional.py``, batched supports, and drawn shifts and
scales), the categorical and Gaussian heads, each algorithm's networks with
copied weights, the DDPG, D4PG, MPO and DMPO learners after 1 and 10 steps
from the reference's state (``state_from_jax``) on the same batches, with
MPO and DMPO handed the reference's normal draws, the behaviour policy at
``evaluation=True``, and the builder's options, replay and adder.

Tolerances, stated where used: 1e-5 on forward outputs, projections and
losses of order 1 (the projection keeps its mass to 1e-5); params and
target params within 1e-4 absolute (a gradient near Adam's eps moves its
weight by lr g / (|g| + eps), so summation-order noise in g moves it by up
to ~lr / 50); Adam's moments within 1e-5 of each leaf's largest magnitude,
but for the three 0-d MPO duals, within 1e-3 of their own: each dual's
gradient is a small difference of much larger terms (the temperature's,
eps + E[logsumexp(Q / T)] - log S - E_w[Q] / T, of terms of order max |Q|,
up to ~30 here against a gradient of ~0.08; the KL duals', of terms of
order 1 against ~1e-5), so f32 rounding in those terms is 1e-4 to 3e-4 of
the gradient in both packages (2.9e-4 seen on DMPO's temperature).
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import replay as jax_replay
from repro.agents import continuous as jax_continuous
from repro.core import make_environment_spec as jax_spec
from repro.core import types as jax_types
from repro.envs import PendulumSwingup as JaxPendulum
from repro.networks import heads as jax_heads
from repro_torch import adders, replay, tree
from repro_torch.agents import continuous
from repro_torch.core import make_environment_spec, types
from repro_torch.envs import PendulumSwingup
from repro_torch.networks import heads
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
FWD_TOL = 1e-5
PARAM_ATOL = 1e-4
MOMENT_TOL = 1e-5
DUAL_TOL = 1e-3
DUALS = ("log_temp", "log_alpha_mean", "log_alpha_std")
BATCH = 16

# small widths, each algorithm at its reference defaults otherwise; a
# target copy every 3 steps so 10 steps cover three copies
ALGOS = {
    "ddpg": dict(algo="ddpg", hidden=32, batch_size=BATCH,
                 target_update_period=3),
    "d4pg": dict(algo="d4pg", hidden=32, batch_size=BATCH, num_atoms=21,
                 vmin=0.0, vmax=60.0, target_update_period=3),
    "mpo": dict(algo="mpo", hidden=32, batch_size=BATCH, mpo_samples=8,
                target_update_period=3),
    "dmpo": dict(algo="dmpo", hidden=32, batch_size=BATCH, mpo_samples=8,
                 num_atoms=21, vmin=0.0, vmax=60.0, target_update_period=3),
}


def _spec():
    return make_environment_spec(PendulumSwingup(seed=0))


def _jax_spec():
    return jax_spec(JaxPendulum(seed=0))


def _t(x):
    return torch.as_tensor(np.array(x))


# ------------------------------------------------------------ l2_project
def test_l2_project_identity():
    z = np.linspace(0, 10, 11, dtype=np.float32)
    p = np.zeros(11, np.float32)
    p[3] = 1.0
    out = heads.l2_project(_t(z), _t(p), _t(z)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_heads.l2_project(
        jnp.asarray(z), jnp.asarray(p), jnp.asarray(z))), atol=1e-6)
    np.testing.assert_allclose(out, p, atol=1e-6)


def test_l2_project_splits_mass_between_neighbours():
    z_q = np.linspace(0.0, 10.0, 11, dtype=np.float32)
    z_p, p = np.array([2.5], np.float32), np.array([1.0], np.float32)
    out = heads.l2_project(_t(z_p), _t(p), _t(z_q)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_heads.l2_project(
        z_p, p, z_q)), atol=1e-7)
    assert out[2] == pytest.approx(0.5) and out[3] == pytest.approx(0.5)


def test_l2_project_clips_out_of_support_mass_to_edges():
    z_q = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    z_p, p = np.array([99.0], np.float32), np.array([1.0], np.float32)
    out = heads.l2_project(_t(z_p), _t(p), _t(z_q)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_heads.l2_project(
        z_p, p, z_q)))
    assert out[-1] == pytest.approx(1.0)


def _project_both(shift, scale):
    z_q = np.linspace(-10.0, 10.0, 21, dtype=np.float32)
    src = (np.linspace(-5.0, 5.0, 11, dtype=np.float32) * np.float32(scale)
           + np.float32(shift))
    p = np.full(11, 1.0 / 11.0, np.float32)
    out = heads.l2_project(_t(src), _t(p), _t(z_q)).numpy()
    ref = np.asarray(jax_heads.l2_project(jnp.asarray(src), jnp.asarray(p),
                                          jnp.asarray(z_q)))
    return out, ref


@pytest.mark.parametrize("shift,scale", [
    (0.0, 1.0), (-20.0, 0.1), (20.0, 2.0), (3.3, 0.7), (-7.25, 1.9),
    (9.99, 0.1), (0.5, 1.0)])
def test_l2_project_preserves_mass_and_matches_reference(shift, scale):
    out, ref = _project_both(shift, scale)
    np.testing.assert_allclose(out, ref, atol=FWD_TOL)
    assert out.sum() == pytest.approx(1.0, abs=1e-5)
    assert (out >= -1e-7).all()


def test_l2_project_preserves_mass_on_drawn_shifts_and_scales():
    """The reference's property test (``test_distributional.py``), drawn by
    hypothesis over the same ranges, each case also against the
    reference's projection."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=50, deadline=None)
    @hypothesis.given(shift=st.floats(-20, 20), scale=st.floats(0.1, 2.0))
    def check(shift, scale):
        out, ref = _project_both(shift, scale)
        np.testing.assert_allclose(out, ref, atol=FWD_TOL)
        assert out.sum() == pytest.approx(1.0, abs=1e-5)
        assert (out >= -1e-7).all()

    check()


def test_l2_project_over_leading_batch_axes_with_repeated_atoms():
    """(B, n_p) sources as the critic loss projects them, and a support
    with repeated atoms (the d_pos == 0 and d_neg == 0 guards)."""
    rng = np.random.RandomState(0)
    z_q = np.array([0.0, 0.0, 1.0, 2.5, 4.0, 4.0], np.float32)
    z_p = (rng.randn(3, 4, 7) * 3 + 2).astype(np.float32)
    p = rng.rand(3, 4, 7).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    out = heads.l2_project(_t(z_p), _t(p), _t(z_q)).numpy()
    ref = np.asarray(jax_heads.l2_project(z_p, p, z_q))
    assert out.shape == ref.shape == (3, 4, 6)
    np.testing.assert_allclose(out, ref, atol=FWD_TOL)


# ------------------------------------------------------------------ heads
def test_categorical_head_matches_reference():
    params = jax_heads.categorical_init(jax.random.key(1), 12, num_atoms=21)
    h = np.random.RandomState(0).randn(5, 12).astype(np.float32)
    ref = jax_heads.categorical_apply(params, h, -3.0, 7.0, 21)
    port = heads.categorical_apply(tree.map(_t, params), _t(h), -3.0, 7.0,
                                   21)
    assert isinstance(port, heads.CategoricalParams)
    np.testing.assert_allclose(port.logits.numpy(), np.asarray(ref.logits),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(port.atoms.numpy(), np.asarray(ref.atoms),
                               atol=1e-6)
    np.testing.assert_allclose(port.mean().numpy(), np.asarray(ref.mean()),
                               atol=FWD_TOL, rtol=FWD_TOL)
    init = heads.categorical_init(torch.Generator().manual_seed(0), 12, 21,
                                  device=CPU)
    assert [tuple(x.shape) for x in tree.leaves(init)] == \
        [x.shape for x in jax.tree.leaves(params)]


def test_gaussian_policy_head_matches_reference():
    params = jax_heads.gaussian_policy_init(jax.random.key(2), 6, 16, 3)
    h = (np.random.RandomState(1).randn(9, 6) * 4).astype(np.float32)
    mean, scale = jax_heads.gaussian_policy_apply(params, h, min_scale=1e-3)
    port_mean, port_scale = heads.gaussian_policy_apply(
        tree.map(_t, params), _t(h), min_scale=1e-3)
    np.testing.assert_allclose(port_mean.numpy(), np.asarray(mean),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(port_scale.numpy(), np.asarray(scale),
                               atol=FWD_TOL, rtol=FWD_TOL)
    assert float(port_scale.min()) >= 1e-3
    init = heads.gaussian_policy_init(torch.Generator().manual_seed(0), 6,
                                      16, 3, device=CPU)
    assert [tuple(x.shape) for x in tree.leaves(init)] == \
        [x.shape for x in jax.tree.leaves(params)]


# ---------------------------------------------------------------- networks
def _jax_params(cfg, seed=0):
    init, *_ = jax_continuous.make_networks(_jax_spec(), cfg)
    return init(jax.random.key(seed))


@pytest.mark.parametrize("algo", ALGOS)
def test_networks_match_reference_with_copied_params(algo):
    cfg = continuous.ContinuousConfig(**ALGOS[algo])
    params = _jax_params(cfg, seed=3)
    rng = np.random.RandomState(0)
    obs = rng.randn(7, 3).astype(np.float32)
    act = rng.uniform(-1, 1, (7, 1)).astype(np.float32)
    _, policy_dist, critic, _, _ = jax_continuous.make_networks(_jax_spec(),
                                                                cfg)
    init, port_dist, port_critic, obs_dim, act_dim = \
        continuous.make_networks(_spec(), cfg, device=CPU)
    assert (obs_dim, act_dim) == (3, 1)
    port_params = tree.map(_t, params)
    mean, std = policy_dist(params, obs)
    port_mean, port_std = port_dist(port_params, _t(obs))
    np.testing.assert_allclose(port_mean.numpy(), np.asarray(mean),
                               atol=FWD_TOL, rtol=FWD_TOL)
    if std is None:
        assert port_std is None
    else:
        np.testing.assert_allclose(port_std.numpy(), np.asarray(std),
                                   atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(
        port_critic(port_params, _t(obs), _t(act)).numpy(),
        np.asarray(critic(params, obs, act)), atol=FWD_TOL, rtol=FWD_TOL)
    port_init = init(torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in tree.leaves(port_init)] == \
        [x.shape for x in jax.tree.leaves(params)]
    assert all(float(port_init[k]) == 0.0
               for k in ("log_temp", "log_alpha_mean", "log_alpha_std"))


# ----------------------------------------------------------------- learner
def _transitions(seed, n=BATCH):
    """A replay batch as the n-step adder writes it on PendulumSwingup:
    3-d observations, (1,) float32 actions in [-1, 1], n-step rewards
    (each step's reward is in [0, 1]) and discounts (0 past a truncation
    is not produced here: pendulum episodes only truncate)."""
    rng = np.random.RandomState(100 + seed)
    th = rng.uniform(-np.pi, np.pi, (2, n))
    thd = rng.uniform(-8, 8, (2, n))
    obs = np.stack([np.cos(th), np.sin(th), thd / 8.0], -1).astype(np.float32)
    return (obs[0], rng.uniform(-1, 1, (n, 1)).astype(np.float32),
            (rng.rand(n) * 3).astype(np.float32),
            (0.99 ** rng.randint(1, 4, n)).astype(np.float32), obs[1], ())


def _samples(steps, port):
    for i in range(steps):
        fields = _transitions(i)
        info = (np.arange(BATCH, dtype=np.int64) + i * BATCH,
                np.full(BATCH, 1.0 / 1000))
        if port:
            yield replay.ReplaySample(replay.SampleInfo(*info),
                                      types.Transition(*fields))
        else:
            yield jax_replay.ReplaySample(jax_replay.SampleInfo(*info),
                                          jax_types.Transition(*fields))


def reference_draws(cfg, steps, batch=BATCH):
    """The reference learner's normal draws, step by step, in the order
    its update splits them: ``fold_in(key(17), step)`` split into the
    critic loss's key (the target policy's noise, (B, A)) and the policy
    loss's, whose first half draws the E-step's samples (S, B, A)."""
    out = []
    for step in range(steps):
        key = jax.random.fold_in(jax.random.key(17), step)
        k_critic, k_policy = jax.random.split(key)
        k_samples, _ = jax.random.split(k_policy)
        out.append(np.asarray(jax.random.normal(k_critic, (batch, 1))))
        out.append(np.asarray(jax.random.normal(
            k_samples, (cfg.mpo_samples, batch, 1))))
    return out


def hand_draws(monkeypatch, draws):
    """Patch the port's one draw function to return ``draws`` in turn."""
    queue = collections.deque(draws)
    seen = []

    def learner_normal(generator, shape):
        x = queue.popleft()
        assert tuple(shape) == x.shape
        seen.append(generator)
        return torch.as_tensor(np.array(x), device=generator.device)

    monkeypatch.setattr(continuous, "learner_normal", learner_normal)
    return queue, seen


def _learners(cfg, steps):
    ref = jax_continuous.make_learner(_jax_spec(), cfg,
                                      _samples(steps, port=False),
                                      jax.random.key(0))
    port = continuous.make_learner(_spec(), cfg, _samples(steps, port=True),
                                   torch.Generator().manual_seed(0),
                                   device=CPU)
    port.state = continuous.state_from_jax(
        jax.tree.map(np.asarray, ref.state), device=CPU)
    return ref, port


def _assert_rel(port, ref, tol):
    """Each leaf within ``tol`` of the reference leaf's largest magnitude."""
    port_leaves = [np.asarray(x) for x in tree.leaves(port)]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(port_leaves) == len(ref_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


def _assert_abs(port, ref, atol):
    port_leaves = [np.asarray(x) for x in tree.leaves(port)]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(port_leaves) == len(ref_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("algo", ALGOS)
def test_learner_steps_match_reference(algo, steps, monkeypatch):
    """The critic loss (expected or C51 through ``l2_project``), the policy
    loss (DPG through the critic, or MPO's E-step, temperature dual,
    weighted ML, decoupled KL and alpha duals), one Adam (clip 40) over
    every param, the periodic target copy: losses each step, then params,
    target params and both Adam states (the critic's never stepped)."""
    cfg = continuous.ContinuousConfig(**ALGOS[algo])
    mpo = algo in ("mpo", "dmpo")
    queue, seen = hand_draws(monkeypatch, reference_draws(cfg, steps)
                             if mpo else [])
    ref, port = _learners(cfg, steps)
    for _ in range(steps):
        ref_metrics, port_metrics = ref.step(), port.step()
        for name in ("critic_loss", "policy_loss", "loss"):
            np.testing.assert_allclose(port_metrics[name], ref_metrics[name],
                                       atol=FWD_TOL, rtol=FWD_TOL)
        assert port_metrics["learner_steps"] == ref_metrics["learner_steps"]
    assert not queue and len(seen) == (2 * steps if mpo else 0)
    state, ref_state = port.state, ref.state
    _assert_abs(state.params, ref_state.params, PARAM_ATOL)
    _assert_abs(state.target_params, ref_state.target_params, PARAM_ATOL)
    (p_opt, c_opt), (ref_p, ref_c) = state.opt_state, ref_state.opt_state
    for moments, ref_moments in ((p_opt.mu, ref_p.mu), (p_opt.nu, ref_p.nu)):
        _assert_rel({k: v for k, v in moments.items() if k not in DUALS},
                    {k: v for k, v in ref_moments.items() if k not in DUALS},
                    MOMENT_TOL)
        for name in DUALS:
            _assert_rel(moments[name], ref_moments[name], DUAL_TOL)
    assert int(p_opt.step) == int(ref_p.step) == steps
    assert int(c_opt.step) == int(ref_c.step) == 0
    assert all(float(x.abs().max()) == 0.0 for x in tree.leaves(c_opt.mu))
    assert int(state.steps) == int(ref_state.steps) == steps
    assert state.steps.dtype == torch.int32


def test_dpg_policy_gradient_reaches_the_critic_as_in_the_reference():
    """``dpg_policy_loss`` differentiates ``q_mean(params, ...)``, so the
    critic's gradient carries the policy loss's term as well as the
    critic loss's (``repro/agents/continuous.py:135-139``): the port's
    critic moments after one step equal the reference's, and differ from
    those of the critic loss alone."""
    cfg = continuous.ContinuousConfig(**ALGOS["ddpg"])
    ref, port = _learners(cfg, 1)
    state = port.state
    port.step()
    ref.step()
    critic_mu = port.state.opt_state[0].mu["critic"]
    _assert_rel(critic_mu, ref.state.opt_state[0].mu["critic"], MOMENT_TOL)
    # the critic loss's gradient alone, for contrast
    sample = next(_samples(1, port=True))
    data = tree.map(torch.as_tensor, sample.data)
    _, policy_dist, critic, _, _ = continuous.make_networks(_spec(), cfg,
                                                            CPU)
    leaves = [w.detach().requires_grad_(True)
              for w in tree.leaves(state.params["critic"])]
    params = dict(state.params, critic=tree.unflatten(
        tree.flatten(state.params["critic"])[1], leaves))
    with torch.no_grad():
        na, _ = policy_dist(state.target_params, data.next_observation)
        y = data.reward + data.discount * critic(
            state.target_params, data.next_observation, na)
    q = critic(params, data.observation, data.action)
    critic_only = torch.autograd.grad(0.5 * torch.mean(torch.square(y - q)),
                                      leaves)
    assert not np.allclose(critic_only[0].numpy() * 0.1,
                           critic_mu[0]["w"].numpy(), atol=1e-7)


@pytest.mark.parametrize("algo", ["ddpg", "d4pg"])
def test_ddpg_family_leaves_the_mpo_duals_untouched(algo):
    cfg = continuous.ContinuousConfig(**ALGOS[algo])
    _, port = _learners(cfg, 3)
    for _ in range(3):
        port.step()
    for name in ("log_temp", "log_alpha_mean", "log_alpha_std"):
        assert float(port.state.params[name]) == 0.0
        assert float(port.state.opt_state[0].mu[name]) == 0.0


def test_mpo_draws_follow_the_host_step_counter(monkeypatch):
    """The learner's draws are seeded from 17 and a step counter kept on
    the host: each step adds one, and a state assigned from outside (a
    restored checkpoint) sets it from its ``steps``.  The same state and
    batches then give the same steps exactly."""
    seeds = []
    draw = continuous.learner_normal

    def recording(generator, shape):
        seeds.append(generator.initial_seed() - 17 * 2 ** 31)
        return draw(generator, shape)

    monkeypatch.setattr(continuous, "learner_normal", recording)
    cfg = continuous.ContinuousConfig(**ALGOS["mpo"])
    batches = list(_samples(2, port=True))
    learner = continuous.make_learner(_spec(), cfg, iter(batches * 3),
                                      torch.Generator().manual_seed(0),
                                      device=CPU)
    start = learner.state
    learner.step()
    learner.step()
    after_two = learner.state
    learner.state = start
    learner.step()
    learner.step()
    for a, b in zip(tree.leaves(after_two), tree.leaves(learner.state)):
        assert torch.equal(a, b)
    learner.state = start._replace(steps=torch.tensor(5, dtype=torch.int32))
    learner.step()
    assert seeds == [0, 0, 1, 1, 0, 0, 1, 1, 5, 5]


# ----------------------------------------------------------- behaviour
@pytest.mark.parametrize("algo", ALGOS)
def test_behavior_policy_at_evaluation_matches_reference(algo):
    cfg = continuous.ContinuousConfig(**ALGOS[algo])
    params = _jax_params(cfg, seed=5)
    obs = np.random.RandomState(2).randn(3).astype(np.float32)
    ref_policy = jax_continuous.make_behavior_policy(_jax_spec(), cfg,
                                                     evaluation=True)
    policy = continuous.make_behavior_policy(_spec(), cfg, evaluation=True)
    out = policy(tree.map(_t, params), torch.Generator(), _t(obs[None]))
    assert out.shape == (1, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy()[0],
                               np.asarray(ref_policy(params, None, obs)),
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("algo", ["ddpg", "mpo"])
def test_behavior_policy_explores_around_the_mean_within_bounds(algo):
    cfg = continuous.ContinuousConfig(**dict(ALGOS[algo], sigma=0.3))
    init, policy_dist, _, _, _ = continuous.make_networks(_spec(), cfg, CPU)
    params = init(torch.Generator().manual_seed(0))
    obs = _t(np.random.RandomState(3).randn(4096, 3).astype(np.float32))
    policy = continuous.make_behavior_policy(_spec(), cfg)
    a = policy(params, torch.Generator().manual_seed(1), obs)
    again = policy(params, torch.Generator().manual_seed(1), obs)
    assert torch.equal(a, again) and a.shape == (4096, 1)
    assert float(a.abs().max()) <= 1.0
    mean, std = policy_dist(params, obs)
    assert not torch.equal(a, torch.clamp(mean, -1, 1))
    inside = (mean.abs() < 0.2).squeeze(-1)
    noise = (a - mean)[inside]
    expected = cfg.sigma if std is None else float(std[inside].mean())
    assert abs(float(noise.std()) - expected) < 0.15 * expected


def test_actor_returns_a_float32_action_of_the_spec_shape():
    from repro_torch.core import FeedForwardActor, VariableClient
    builder = continuous.ContinuousBuilder(
        _spec(), continuous.ContinuousConfig(**ALGOS["d4pg"]), seed=0,
        device=CPU)
    learner = builder.make_learner(iter(()))
    actor = builder.make_actor(builder.make_policy(), VariableClient(learner),
                               adder=None, seed=0)
    assert isinstance(actor, FeedForwardActor)
    action = actor.select_action(PendulumSwingup(seed=0).reset().observation)
    assert isinstance(action, np.ndarray)
    assert action.shape == (1,) and action.dtype == np.float32


# ----------------------------------------------------------------- builder
@pytest.mark.parametrize("kwargs", [
    {}, dict(samples_per_insert=0.0, min_replay_size=300),
    dict(samples_per_insert=2.0, batch_size=8), ALGOS["dmpo"]])
def test_builder_options_replay_and_adder_match_reference(kwargs):
    cfg = continuous.ContinuousConfig(**kwargs)
    port = continuous.ContinuousBuilder(_spec(), cfg, seed=2, device=CPU)
    ref = jax_continuous.ContinuousBuilder(
        _jax_spec(), jax_continuous.ContinuousConfig(**kwargs), seed=2)
    assert dataclasses.asdict(port.options) == \
        dataclasses.asdict(ref.options)
    table, ref_table = port.make_replay(), ref.make_replay()
    assert type(table.selector).__name__ == type(ref_table.selector).__name__
    limiter, ref_limiter = table.rate_limiter, ref_table.rate_limiter
    assert type(limiter).__name__ == type(ref_limiter).__name__
    assert limiter.state_dict() == ref_limiter.state_dict()
    assert table.capacity == ref_table.capacity
    adder, ref_adder = port.make_adder(table), ref.make_adder(ref_table)
    assert isinstance(adder, adders.NStepTransitionAdder)
    assert (adder.n, adder.gamma) == (ref_adder.n, ref_adder.gamma)
    assert port.make_learner(iter(())).state.params["policy"][0]["w"] \
        .device.type == "cpu"


def test_builder_for_builds_each_algorithm():
    assert dataclasses.asdict(continuous.ContinuousConfig()) == \
        dataclasses.asdict(jax_continuous.ContinuousConfig())
    for algo in ALGOS:
        builder = continuous.builder_for(algo, _spec(), seed=1, device=CPU,
                                         hidden=16)
        assert builder.cfg.algo == algo and builder.cfg.hidden == 16
        assert builder.seed == 1 and builder.device == CPU
