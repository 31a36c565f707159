"""The reference's async-parameter-service failover acceptance on the port,
on the CPU, at the reference's config and threshold
(``tests/test_resilience.py::
test_failover_acceptance_kill_async_param_service_still_learns``): chaos
kills the ``learner/param_service`` node mid-run under
``learner_sync="async"``.  The watchdog restores it from its snapshot at
the same address; the replicas' pushes and pulls resume; no replica or
worker dies of ``ServiceUnavailable``; and the run still learns.
"""
from repro_torch.experiments import run_distributed_experiment
from repro_torch.resilience import ChaosPolicy, RestartPolicy
from torch_factories import make_dqn_catch_config
from torch_threads import one_torch_thread  # noqa: F401

CATCH_FLOOR = -0.6   # random policy mean return on Catch is ~-1..-0.6


def test_failover_acceptance_kill_async_param_service_still_learns():
    config = make_dqn_catch_config(
        seed=0, eval_episodes=20, launcher="multiprocess",
        num_learner_replicas=2, learner_average_period=10,
        learner_sync="async",
        restart_policy=RestartPolicy(max_restarts=3),
        chaos=ChaosPolicy(kill_after_steps=20,
                          kill_targets=("learner/param_service",),
                          max_kills=1))
    result = run_distributed_experiment(config, num_actors=2,
                                        max_actor_steps=4000, timeout_s=300)
    assert result.counts.get("actor_steps", 0) >= 4000
    resilience = result.extras["resilience"]
    assert resilience["service_restarts"].get("learner/param_service") == 1, \
        resilience
    # no WORKER died: replicas degraded through the restart window
    assert resilience["restarts"] == {}, resilience
    learners = result.extras["learners"]
    assert learners["sync"] == "async"
    assert learners["rounds"] > 0            # exchanges resumed post-restore
    assert all(s > 0 for s in learners["per_replica_steps"])
    assert result.final_eval_return is not None
    assert result.final_eval_return > CATCH_FLOOR
