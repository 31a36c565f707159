"""The reference's chaos acceptance on the port, on the CPU, at the
reference's config and threshold
(``tests/test_resilience.py::test_chaos_acceptance_kill_actor_still_learns``):
a seeded chaos kill takes ``actor/0`` down after 400 environment steps of
DQN on Catch under the multiprocess launcher; the supervisor classifies the
crash, respawns the replica (which disarms its schedule), and the run still
clears the learning floor.

Builders take ``device="cpu"``; the factories live in
``tests/torch_factories.py`` so spawned (and respawned) children import
them without jax.
"""
from repro_torch.experiments import run_distributed_experiment
from repro_torch.resilience import CRASH, ChaosPolicy, RestartPolicy
from torch_factories import make_dqn_catch_config
from torch_threads import one_torch_thread  # noqa: F401

CATCH_FLOOR = -0.6   # random policy mean return on Catch is ~-1..-0.6


def test_chaos_acceptance_kill_actor_still_learns():
    config = make_dqn_catch_config(
        seed=0, eval_episodes=20, launcher="multiprocess",
        restart_policy=RestartPolicy(max_restarts=3),
        chaos=ChaosPolicy(kill_after_steps=400, kill_targets=("actor/0",),
                          max_kills=1))
    result = run_distributed_experiment(config, num_actors=2,
                                        max_actor_steps=4000, timeout_s=240)
    assert result.counts.get("actor_steps", 0) >= 4000
    resilience = result.extras["resilience"]
    assert resilience["restarts"].get("actor/0") == 1, resilience
    assert CRASH in resilience["exit_kinds"]["actor/0"]
    # learning: greedy eval beats the random-policy floor on Catch
    assert result.final_eval_return is not None
    assert result.final_eval_return > CATCH_FLOOR
