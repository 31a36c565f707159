"""The reference's distributed acceptances on the port, on the CPU, at the
reference's own configs and thresholds:

- ``tests/test_system.py::test_distributed_dqn_runs_and_learns``
  (``make_distributed_agent``, two actor threads, SPI 8);
- ``tests/test_distributed.py::
  test_multiprocess_dqn_on_catch_learning_smoke`` (actors and the
  evaluator in spawned processes, two replay shards, 4000 actor steps,
  final eval > -0.6, 1 < effective SPI < 8);
- ``tests/test_multi_learner.py::test_two_replica_dqn_on_catch_learns``
  (local launcher: two learner replicas averaging every 10 steps);
- ``tests/test_policies.py::
  test_transformer_policy_server_inference_{local,multiprocess}_launcher``
  (the transformer policy served by ``TransformerInferenceServer``).

Builders take ``device="cpu"``; the factories live in
``tests/torch_factories.py`` so spawned children import them without jax.
"""
import time

import numpy as np

from repro_torch.agents.builders import make_distributed_agent
from repro_torch.agents.dqn import DQNBuilder, DQNConfig
from repro_torch.core import make_environment_spec
from repro_torch.envs import Catch
from repro_torch.experiments import run_distributed_experiment
from torch_factories import (make_dqn_catch_config,
                             make_transformer_catch_config)
from torch_threads import one_torch_thread  # noqa: F401

CATCH_FLOOR = -0.6   # random policy mean return on Catch is ~-1..-0.6


def test_distributed_dqn_runs_and_learns():
    spec = make_environment_spec(Catch(seed=0))
    cfg = DQNConfig(min_replay_size=50, samples_per_insert=8.0,
                    batch_size=32, n_step=1, epsilon=0.2)
    builder = DQNBuilder(spec, cfg, seed=1, device="cpu")
    dist = make_distributed_agent(builder, lambda seed: Catch(seed=seed),
                                  num_actors=2)
    deadline = time.time() + 60
    try:
        while time.time() < deadline:
            counts = dist.counter.get_counts()
            if counts.get("actor_steps", 0) > 3000:
                break
            time.sleep(0.5)
        counts = dist.counter.get_counts()
        assert counts.get("actor_steps", 0) > 500, counts
        assert int(dist.learner.state.steps) > 10
        rl = dist.table.rate_limiter
        assert rl.samples > 0 and rl.inserts > rl.min_size_to_sample
    finally:
        dist.stop()


def test_multiprocess_dqn_on_catch_learning_smoke():
    config = make_dqn_catch_config(
        seed=0, eval_episodes=20, num_replay_shards=2,
        launcher="multiprocess")
    result = run_distributed_experiment(config, num_actors=2,
                                        max_actor_steps=4000,
                                        timeout_s=240,
                                        with_evaluator=True)
    counts = result.counts
    assert counts.get("actor_steps", 0) >= 4000, counts
    assert result.learner_steps > 50
    assert result.extras["launcher"] == "multiprocess"
    assert result.extras["inserts"] > result.extras["min_size_to_sample"]
    assert result.extras["samples"] > 0
    assert 1.0 < result.extras["spi_effective"] < 8.0
    assert len(result.extras["evaluator_returns"]) >= 1
    per_shard = result.extras["replay"]["per_shard"]
    assert len(per_shard) == 2 and all(s["inserts"] > 0 for s in per_shard)
    assert result.final_eval_return is not None
    assert result.final_eval_return > CATCH_FLOOR


def test_two_replica_dqn_on_catch_learns():
    config = make_dqn_catch_config(
        seed=0, eval_episodes=20, launcher="local",
        num_learner_replicas=2, learner_average_period=10)
    result = run_distributed_experiment(config, num_actors=2,
                                        max_actor_steps=4000,
                                        timeout_s=240)
    assert result.counts.get("actor_steps", 0) >= 4000
    assert result.learner_steps > 50
    learners = result.extras["learners"]
    assert learners["num_replicas"] == 2
    assert learners["rounds"] >= 1
    assert all(s > 0 for s in learners["per_replica_steps"])
    per_shard = result.extras["replay"]["per_shard"]
    assert len(per_shard) == 2
    assert all(s["samples"] > 0 for s in per_shard)
    assert result.final_eval_return is not None
    assert result.final_eval_return > CATCH_FLOOR


def test_transformer_policy_server_inference_local_launcher():
    config = make_transformer_catch_config(
        seed=0, launcher="local", inference="server", num_envs_per_actor=2)
    result = run_distributed_experiment(config, num_actors=2,
                                        max_actor_steps=400, timeout_s=120)
    assert result.counts["actor_steps"] > 0
    assert result.learner_steps > 0
    stats = result.extras["inference"]
    assert stats["decode_rows"] > stats["prefill_rows"] > 0
    assert stats["batches"] > 0
    assert np.isfinite(result.final_eval_return)


def test_transformer_policy_server_inference_multiprocess_launcher():
    config = make_transformer_catch_config(
        seed=0, launcher="multiprocess", inference="server",
        num_envs_per_actor=2)
    result = run_distributed_experiment(config, num_actors=2,
                                        max_actor_steps=300, timeout_s=400)
    assert result.counts["actor_steps"] > 0
    stats = result.extras["inference"]
    assert stats["decode_rows"] > 0 and stats["prefill_rows"] > 0
