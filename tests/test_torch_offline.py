"""repro_torch's behaviour cloning and offline runs against the JAX
package: the BC learner (discrete NLL on Catch, continuous MSE of tanh on
PendulumSwingup) after 1 and 10 steps from the reference's state
(``state_from_jax``) on the same batches, the eval policy on copied
weights, ``BCBuilder``'s options, preloaded table and absent adder, and
``run_offline_experiment`` against the reference's on the same dataset:
the learner's steps, the dataset's size, the eval cadence and, from the
reference's initial weights, the eval returns themselves (greedy acting
on Catch draws nothing, and the table samples with the same
``random.Random``).

Tolerances: 1e-5 on forward outputs and losses of order 1; params within
1e-4 absolute (summation-order noise in a gradient near Adam's eps moves
its weight by up to ~lr / 50); Adam's moments within 1e-5 of each leaf's
largest magnitude; actions and eval returns equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.adders import NStepTransitionAdder as JaxNStepAdder
from repro.agents import bc as jax_bc
from repro.core import make_environment_spec as jax_spec
from repro.envs import Catch as JaxCatch
from repro.envs import PendulumSwingup as JaxPendulum
from repro.experiments import ExperimentConfig as JaxExperimentConfig
from repro.experiments import run_offline_experiment as jax_run_offline
from repro import replay as jax_replay
from repro_torch import replay, tree
from repro_torch.adders import NStepTransitionAdder
from repro_torch.agents import bc, dqn
from repro_torch.core import make_environment_spec
from repro_torch.envs import Catch, PendulumSwingup
from repro_torch.experiments import ExperimentConfig, run_offline_experiment
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
FWD_TOL = 1e-5
PARAM_ATOL = 1e-4
MOMENT_TOL = 1e-5


def collect(port, env_name="catch", episodes=6, seed=0):
    """Transitions of a seeded random policy, written by each package's own
    n-step-1 adder into its own table (the reference's test helper)."""
    if port:
        env = Catch(seed=seed) if env_name == "catch" else \
            PendulumSwingup(seed=seed, episode_len=20)
        table = replay.Table("tmp", 10_000, replay.Uniform(0),
                             replay.MinSize(1))
        adder = NStepTransitionAdder(table, 1, 0.99)
    else:
        env = JaxCatch(seed=seed) if env_name == "catch" else \
            JaxPendulum(seed=seed, episode_len=20)
        table = jax_replay.Table("tmp", 10_000, jax_replay.Uniform(0),
                                 jax_replay.MinSize(1))
        adder = JaxNStepAdder(table, 1, 0.99)
    rng = np.random.RandomState(seed)
    for _ in range(episodes):
        ts = env.reset()
        adder.add_first(ts)
        while not ts.last():
            if env_name == "catch":
                a = np.int32(rng.randint(3))
            else:
                a = rng.uniform(-1, 1, (1,)).astype(np.float32)
            ts = env.step(a)
            adder.add(a, ts)
    return [table._items[k].data for k in table._order]


def _specs(env_name):
    if env_name == "catch":
        return make_environment_spec(Catch()), jax_spec(JaxCatch())
    return (make_environment_spec(PendulumSwingup()),
            jax_spec(JaxPendulum()))


CASES = {"discrete": ("catch", dict(batch_size=16, hidden=32)),
         "continuous": ("pendulum", dict(batch_size=16, hidden=32,
                                         continuous=True))}


def _learners(name, seed=0):
    env_name, knobs = CASES[name]
    cfg = bc.BCConfig(**knobs)
    spec, ref_spec = _specs(env_name)
    ref = jax_bc.make_learner(
        ref_spec, cfg, jax_replay.dataset_from_list(
            collect(False, env_name), cfg.batch_size, seed=seed),
        jax.random.key(seed))
    port = bc.make_learner(
        spec, cfg, replay.dataset_from_list(collect(True, env_name),
                                            cfg.batch_size, seed=seed),
        torch.Generator().manual_seed(seed), device=CPU)
    port.state = bc.state_from_jax(jax.tree.map(np.asarray, ref.state), CPU)
    return ref, port, cfg, spec, ref_spec


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


def test_collected_datasets_are_the_references():
    for env_name in ("catch", "pendulum"):
        port, ref = collect(True, env_name), collect(False, env_name)
        assert len(port) == len(ref) > 0
        for a, b in zip(port, ref):
            for x, y in zip(tree.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("name", CASES)
def test_bc_learner_steps_match_reference(name, steps):
    """The log-softmax NLL of the taken action, or the MSE of tanh of the
    output, with Adam (no clip): the loss each step, then params and
    Adam's state; no target params."""
    ref, port, _, _, _ = _learners(name)
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
    assert int(state.opt_state.step) == int(ref_state.opt_state.step) == steps
    assert int(state.steps) == int(ref_state.steps) == steps
    assert state.steps.dtype == torch.int32


@pytest.mark.parametrize("name", CASES)
def test_eval_policy_matches_reference(name):
    env_name, knobs = CASES[name]
    cfg = bc.BCConfig(**knobs)
    spec, ref_spec = _specs(env_name)
    init, *_ = jax_bc.make_network(ref_spec, cfg)
    params = init(jax.random.key(4))
    port_params = tree.map(lambda x: torch.as_tensor(np.array(x)), params)
    ref_policy = jax_bc.make_eval_policy(ref_spec, cfg)
    policy = bc.make_eval_policy(spec, cfg)
    items = collect(True, env_name)
    obs = np.stack([t.observation for t in items[:20]])
    out = policy(port_params, torch.Generator(), torch.as_tensor(obs))
    ref_out = np.stack([np.asarray(ref_policy(params, None, o)) for o in obs])
    if cfg.continuous:
        assert out.shape == (20, 1) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref_out, atol=FWD_TOL)
    else:
        assert out.shape == (20,) and out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref_out)


def test_network_init_has_the_reference_leaves():
    for env_name, knobs in CASES.values():
        cfg = bc.BCConfig(**knobs)
        spec, ref_spec = _specs(env_name)
        init, *_ = bc.make_network(spec, cfg, device=CPU)
        ref_init, *_ = jax_bc.make_network(ref_spec, cfg)
        assert [tuple(x.shape) for x in tree.leaves(
            init(torch.Generator().manual_seed(0)))] == \
            [x.shape for x in jax.tree.leaves(ref_init(jax.random.key(0)))]


# ----------------------------------------------------------------- builder
def test_builder_preloads_its_table_and_has_no_adder():
    items = collect(True)
    builder = bc.BCBuilder(_specs("catch")[0], items, bc.BCConfig(
        batch_size=8), seed=3, device=CPU)
    ref = jax_bc.BCBuilder(_specs("catch")[1], collect(False),
                           jax_bc.BCConfig(batch_size=8), seed=3)
    assert dataclasses.asdict(builder.options) == \
        dataclasses.asdict(ref.options)
    assert builder.options.offline
    table, ref_table = builder.make_replay(), ref.make_replay()
    assert table.size() == ref_table.size() == len(items)
    assert table.capacity == ref_table.capacity == len(items)
    assert type(table.selector).__name__ == "Uniform"
    assert type(table.rate_limiter).__name__ == "MinSize"
    assert table.rate_limiter.state_dict() == \
        ref_table.rate_limiter.state_dict()
    assert builder.make_adder(table) is None
    batch = next(builder.make_dataset(table))
    ref_batch = next(ref.make_dataset(ref_table))
    np.testing.assert_array_equal(batch.info.keys, ref_batch.info.keys)
    for x, y in zip(tree.leaves(batch.data), jax.tree.leaves(ref_batch.data)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with pytest.raises(ValueError, match="non-empty"):
        bc.BCBuilder(_specs("catch")[0], [], device=CPU)


# ----------------------------------------------------------------- offline
def _from_reference_init(builder):
    """``builder`` with a learner that starts from the reference's initial
    state for the same seed, so the two runs can be compared whole (a
    wrapped method, not a subclass: subclasses register as builders)."""
    make_learner = builder.make_learner

    def from_reference(iterator, priority_update_cb=None):
        learner = make_learner(iterator, priority_update_cb)
        ref = jax_bc.make_learner(_specs("catch")[1], builder.cfg, iter(()),
                                  jax.random.key(builder.seed))
        learner.state = bc.state_from_jax(
            jax.tree.map(np.asarray, ref.state), builder.device)
        return learner

    builder.make_learner = from_reference
    return builder


def _offline_configs(eval_every, eval_episodes=3):
    items, ref_items = collect(True), collect(False)
    cfg = dict(batch_size=16)
    port = ExperimentConfig(
        builder_factory=lambda spec: _from_reference_init(bc.BCBuilder(
            spec, items, bc.BCConfig(**cfg), seed=0, device=CPU)),
        environment_factory=lambda s: Catch(seed=s), seed=0,
        eval_every=eval_every, eval_episodes=eval_episodes)
    ref = JaxExperimentConfig(
        builder_factory=lambda spec: jax_bc.BCBuilder(
            spec, ref_items, jax_bc.BCConfig(**cfg), seed=0),
        environment_factory=lambda s: JaxCatch(seed=s), seed=0,
        eval_every=eval_every, eval_episodes=eval_episodes)
    return port, ref, len(items)


@pytest.mark.parametrize("steps,eval_every", [(20, 0), (25, 10), (30, 10)])
def test_run_offline_experiment_matches_reference(steps, eval_every):
    """The same learner steps, dataset size and eval points (every
    ``eval_every`` steps and a final one unless the last periodic eval
    fell on the end), and, from the same initial weights on the same
    batches, the same greedy eval returns."""
    port_cfg, ref_cfg, n = _offline_configs(eval_every)
    result = run_offline_experiment(port_cfg, num_learner_steps=steps)
    ref = jax_run_offline(ref_cfg, num_learner_steps=steps)
    assert result.learner_steps == ref.learner_steps == steps
    assert result.extras["dataset_size"] == ref.extras["dataset_size"] == n
    assert [s for s, _ in result.eval_returns] == \
        [s for s, _ in ref.eval_returns]
    assert result.eval_returns == ref.eval_returns
    assert result.train_returns == [] and result.actor_steps == []
    assert result.counts == {} and len(result.walltime) == 1
    assert type(result.builder) is bc.BCBuilder
    _assert_close(result.learner.state.params, ref.learner.state.params,
                  atol=PARAM_ATOL)


def test_run_offline_experiment_saves_a_learner_checkpoint(tmp_path):
    from repro_torch.checkpoint import Checkpointer
    port_cfg, _, _ = _offline_configs(0, eval_episodes=0)
    port_cfg = dataclasses.replace(port_cfg, checkpoint_dir=str(tmp_path))
    result = run_offline_experiment(port_cfg, num_learner_steps=5)
    assert result.eval_returns == []
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.latest_step() == 5
    restored = ckpt.restore(result.learner.state)
    for a, b in zip(tree.leaves(restored), tree.leaves(result.learner.state)):
        assert torch.equal(torch.as_tensor(a), b)


def test_run_offline_experiment_rejects_an_online_builder():
    config = ExperimentConfig(
        builder_factory=lambda spec: dqn.DQNBuilder(spec, seed=0,
                                                    device=CPU),
        environment_factory=lambda s: Catch(seed=s))
    with pytest.raises(ValueError, match="offline"):
        run_offline_experiment(config, num_learner_steps=1)
