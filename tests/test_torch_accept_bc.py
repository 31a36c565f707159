"""The reference's offline acceptances on the port.

``tests/test_system.py::test_offline_learner_from_fixed_dataset``: 120
Catch episodes of a track-the-ball policy with 20% exploration (seed 5);
BC (``BCConfig()``, learner seed 1) after 300 steps must return more than
0.3 a greedy episode over 20 episodes of Catch(seed=9), and the offline
double-DQN learner (unprioritized) over 400 steps on the same data must
keep its losses finite and end, over the last 50, below its first 5.
``tests/test_builders_api.py::test_offline_experiment_runs_bc`` and
``::test_offline_experiment_rejects_online_builder``: ``BCBuilder``
through ``run_offline_experiment``.
"""
import numpy as np
import pytest
import torch

from repro_torch.adders import NStepTransitionAdder
from repro_torch.agents import bc as bc_lib
from repro_torch.agents import dqn as dqn_lib
from repro_torch.core import (EnvironmentLoop, FeedForwardActor,
                              VariableClient, make_environment_spec)
from repro_torch.envs import Catch
from repro_torch.experiments import ExperimentConfig, run_offline_experiment
from repro_torch.replay import MinSize, Table, Uniform, dataset_from_list
from torch_threads import one_torch_thread  # noqa: F401


def _behaviour_data(episodes=120, explore=0.2, seed=5):
    env = Catch(seed=seed)
    table = Table("tmp", 100_000, Uniform(0), MinSize(1))
    adder = NStepTransitionAdder(table, 1, 0.99)
    rng = np.random.RandomState(seed)
    for _ in range(episodes):
        ts = env.reset()
        adder.add_first(ts)
        while not ts.last():
            board = ts.observation
            ball = int(np.argmax(board[:-1].max(axis=0)))
            paddle = int(np.argmax(board[-1]))
            a = int(1 + np.sign(ball - paddle))
            if rng.rand() < explore:
                a = int(rng.randint(3))
            ts = env.step(a)
            adder.add(a, ts)
    return [table._items[k].data for k in table._order]


def _evaluate(learner, policy, episodes=20):
    actor = FeedForwardActor(policy, VariableClient(learner), device="cpu")
    loop = EnvironmentLoop(Catch(seed=9), actor)
    return np.mean([loop.run_episode()["episode_return"]
                    for _ in range(episodes)])


def test_offline_learner_from_fixed_dataset():
    spec = make_environment_spec(Catch(seed=5))
    items = _behaviour_data()
    bcfg = bc_lib.BCConfig()
    bl = bc_lib.make_learner(spec, bcfg, dataset_from_list(items, 64),
                             torch.Generator().manual_seed(1), device="cpu")
    for _ in range(300):
        bl.step()
    bc_ret = _evaluate(bl, bc_lib.make_eval_policy(spec, bcfg))
    assert bc_ret > 0.3, bc_ret

    cfg = dqn_lib.DQNConfig(prioritized=False)
    learner = dqn_lib.make_learner(spec, cfg, dataset_from_list(items, 64),
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
    losses = [learner.step()["loss"] for _ in range(400)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-50:]) < np.mean(losses[:5])


def _random_catch_transitions(n_episodes):
    env = Catch(seed=0)
    table = Table("tmp", 10_000, Uniform(0), MinSize(1))
    adder = NStepTransitionAdder(table, 1, 0.99)
    rng = np.random.RandomState(0)
    for _ in range(n_episodes):
        ts = env.reset()
        adder.add_first(ts)
        while not ts.last():
            a = int(rng.randint(3))
            ts = env.step(a)
            adder.add(a, ts)
    return [table._items[k].data for k in table._order]


def test_offline_experiment_runs_bc():
    items = _random_catch_transitions(6)
    config = ExperimentConfig(
        builder_factory=lambda spec: bc_lib.BCBuilder(
            spec, items, bc_lib.BCConfig(batch_size=16), seed=0,
            device="cpu"),
        environment_factory=lambda s: Catch(seed=s),
        seed=0, eval_episodes=2)
    result = run_offline_experiment(config, num_learner_steps=20)
    assert result.learner_steps == 20
    assert result.extras["dataset_size"] == len(items)
    assert np.isfinite(result.final_eval_return)


def test_offline_experiment_rejects_online_builder():
    config = ExperimentConfig(
        builder_factory=lambda spec: dqn_lib.DQNBuilder(spec, seed=0,
                                                        device="cpu"),
        environment_factory=lambda s: Catch(seed=s))
    with pytest.raises(ValueError, match="offline"):
        run_offline_experiment(config, num_learner_steps=1)
