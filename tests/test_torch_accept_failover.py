"""The reference's service-failover acceptance on the port, on the CPU, at
the reference's config and threshold
(``tests/test_resilience.py::
test_failover_acceptance_kill_shard_and_replica_still_learns``): chaos
kills BOTH ``replay/shard_0`` and ``learner/replica_0`` mid-training (two
replicas under quorum averaging, multiprocess actors).  The service
watchdog restores each from its snapshot and re-binds its server; no
worker dies of ``ServiceUnavailable``; averaging rounds keep completing;
and the run still learns.
"""
from repro_torch.experiments import run_distributed_experiment
from repro_torch.resilience import CRASH, ChaosPolicy, RestartPolicy
from torch_factories import make_dqn_catch_config
from torch_threads import one_torch_thread  # noqa: F401

CATCH_FLOOR = -0.6   # random policy mean return on Catch is ~-1..-0.6


def test_failover_acceptance_kill_shard_and_replica_still_learns():
    config = make_dqn_catch_config(
        seed=0, eval_episodes=20, launcher="multiprocess",
        num_learner_replicas=2, learner_average_period=10,
        barrier_timeout_s=2.0, min_quorum=1,
        restart_policy=RestartPolicy(max_restarts=3),
        chaos=ChaosPolicy(kill_after_steps=300,
                          kill_targets=("replay/shard_0",
                                        "learner/replica_0"),
                          max_kills=1))
    result = run_distributed_experiment(config, num_actors=2,
                                        max_actor_steps=4000, timeout_s=300)
    assert result.counts.get("actor_steps", 0) >= 4000
    resilience = result.extras["resilience"]
    assert resilience["service_restarts"].get("replay/shard_0") == 1, \
        resilience
    assert resilience["service_restarts"].get("learner/replica_0") == 1, \
        resilience
    assert CRASH in resilience["service_exit_kinds"]["replay/shard_0"]
    assert CRASH in resilience["service_exit_kinds"]["learner/replica_0"]
    # no WORKER died: actors absorbed the outage with skipped adds
    assert resilience["restarts"] == {}, resilience
    # averaging kept going through the replica outage
    assert result.extras["learners"]["rounds"] > 0
    assert result.final_eval_return is not None
    assert result.final_eval_return > CATCH_FLOOR
