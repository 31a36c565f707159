"""The reference's async-learner acceptance on the port, on the CPU, at the
reference's config and threshold (``tests/test_async_learner.py::
test_two_replica_async_dqn_on_catch_learns``): ``learner_sync="async"``
trains DQN on Catch through the unchanged ``DQNBuilder`` on both launchers
— two free-running replica SGD streams exchanging through the push/pull
service clear the eval bar, and ``extras["learners"]`` reports the async
exchange.
"""
import pytest

from repro_torch.experiments import run_distributed_experiment
from torch_factories import make_dqn_catch_config
from torch_threads import one_torch_thread  # noqa: F401

CATCH_FLOOR = -0.6   # random policy mean return on Catch is ~-1..-0.6


@pytest.mark.parametrize("launcher", ["local", "multiprocess"])
def test_two_replica_async_dqn_on_catch_learns(launcher):
    config = make_dqn_catch_config(
        seed=0, eval_episodes=20, launcher=launcher,
        num_learner_replicas=2, learner_average_period=10,
        learner_sync="async")
    result = run_distributed_experiment(config, num_actors=2,
                                        max_actor_steps=4000,
                                        timeout_s=240)
    assert result.counts.get("actor_steps", 0) >= 4000
    assert result.learner_steps > 50
    learners = result.extras["learners"]
    assert learners["num_replicas"] == 2
    assert learners["sync"] == "async"
    assert learners["rounds"] >= 1
    assert learners["service"]["pushes"] >= 2
    assert all(s > 0 for s in learners["per_replica_steps"])
    # both shards fed their replica
    per_shard = result.extras["replay"]["per_shard"]
    assert len(per_shard) == 2
    assert all(s["samples"] > 0 for s in per_shard)
    # learning: greedy eval beats the random-policy floor on Catch
    assert result.final_eval_return is not None
    assert result.final_eval_return > CATCH_FLOOR
