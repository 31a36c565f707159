"""Repeat one of the reference's distributed DQN acceptances on the port
and print each run's final eval and pass rate.

The acceptances run asynchronously, so their outcome depends on how the
threads or processes interleave.  This script runs one ``--runs`` times on
each launcher asked for and prints one JSON line a run (final eval,
learner steps, effective SPI, averaging rounds, restarts), then a summary
a launcher: the spread of the final evals and how often a run passed the
reference's floor.  Which acceptance:

- ``--sync barrier`` (default): ``tests/test_multi_learner.py::
  test_two_replica_dqn_on_catch_learns`` — conftest's DQN preset on Catch,
  seed 0, 2 actors, 2 learner replicas averaging every 10 steps, 4000
  actor steps, 20 eval episodes, final eval > -0.6;
- ``--sync async``: ``tests/test_async_learner.py::
  test_two_replica_async_dqn_on_catch_learns``, the same with
  ``learner_sync="async"``;
- ``--chaos actor``: ``tests/test_resilience.py::
  test_chaos_acceptance_kill_actor_still_learns`` (one learner, actor/0
  killed after 400 steps and respawned);
- ``--chaos shard_replica``: ``::
  test_failover_acceptance_kill_shard_and_replica_still_learns``
  (replay/shard_0 and learner/replica_0 killed after 300 steps of
  activity and restored, quorum averaging);
- ``--chaos param_service``: ``::
  test_failover_acceptance_kill_async_param_service_still_learns``
  (async replicas, learner/param_service killed and restored).

Chaos runs need the multiprocess launcher, as the reference's do.

    PYTHONPATH=src python scripts/acceptance_repeats.py --runs 10 \\
        --device cuda --launchers local multiprocess
    PYTHONPATH=src python scripts/acceptance_repeats.py --runs 20 \\
        --device cuda --launchers multiprocess --chaos shard_replica

The work stays under ``__main__`` and the builder factory is at module
level: the multiprocess launcher's children re-import this file.
"""
import argparse
import json
import time

CATCH_FLOOR = -0.6
DQN_SMOKE = dict(min_replay_size=50, samples_per_insert=4.0, batch_size=16,
                 n_step=1, epsilon=0.2)
CHAOS = ("none", "actor", "shard_replica", "param_service")


class DQNFactory:
    """``spec -> DQNBuilder`` at conftest's DQN preset on ``device``."""

    def __init__(self, device):
        self.device = device

    def __call__(self, spec):
        from repro_torch.agents.dqn import DQNBuilder, DQNConfig
        return DQNBuilder(spec, DQNConfig(**DQN_SMOKE), seed=0,
                          device=self.device)


def catch_env(seed):
    from repro_torch.envs import Catch
    return Catch(seed=seed)


def acceptance_knobs(sync, chaos):
    """``(ExperimentConfig knobs, timeout_s)`` of the acceptance asked for,
    as the reference's test sets them."""
    from repro_torch.resilience import ChaosPolicy, RestartPolicy
    replicas = dict(num_learner_replicas=2, learner_average_period=10)
    if chaos == "actor":
        return dict(restart_policy=RestartPolicy(max_restarts=3),
                    chaos=ChaosPolicy(kill_after_steps=400,
                                      kill_targets=("actor/0",),
                                      max_kills=1)), 240
    if chaos == "shard_replica":
        return dict(replicas, barrier_timeout_s=2.0, min_quorum=1,
                    restart_policy=RestartPolicy(max_restarts=3),
                    chaos=ChaosPolicy(kill_after_steps=300,
                                      kill_targets=("replay/shard_0",
                                                    "learner/replica_0"),
                                      max_kills=1)), 300
    if chaos == "param_service":
        return dict(replicas, learner_sync="async",
                    restart_policy=RestartPolicy(max_restarts=3),
                    chaos=ChaosPolicy(kill_after_steps=20,
                                      kill_targets=("learner/param_service",),
                                      max_kills=1)), 300
    return dict(replicas, learner_sync=sync), 240


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--launchers", nargs="+",
                        default=["local", "multiprocess"])
    parser.add_argument("--sync", choices=("barrier", "async"),
                        default="barrier")
    parser.add_argument("--chaos", choices=CHAOS, default="none")
    args = parser.parse_args()
    if args.chaos != "none" and args.launchers != ["multiprocess"]:
        parser.error("--chaos runs need --launchers multiprocess")

    import torch

    from repro_torch.experiments import (ExperimentConfig,
                                         run_distributed_experiment)
    if args.device == "cpu":
        torch.set_num_threads(1)
    knobs, timeout_s = acceptance_knobs(args.sync, args.chaos)
    finals = {launcher: [] for launcher in args.launchers}
    for _ in range(args.runs):
        for launcher in args.launchers:
            config = ExperimentConfig(
                builder_factory=DQNFactory(args.device),
                environment_factory=catch_env, seed=0, eval_episodes=20,
                launcher=launcher, **knobs)
            t0 = time.monotonic()
            result = run_distributed_experiment(config, num_actors=2,
                                                max_actor_steps=4000,
                                                timeout_s=timeout_s)
            finals[launcher].append(result.final_eval_return)
            learners = result.extras.get("learners", {})
            print(json.dumps({
                "launcher": launcher, "device": args.device,
                "sync": knobs.get("learner_sync", "barrier"),
                "chaos": args.chaos,
                "final_eval": result.final_eval_return,
                "passed": result.final_eval_return > CATCH_FLOOR,
                "actor_steps": result.counts.get("actor_steps", 0),
                "learner_steps": result.learner_steps,
                "spi_effective": result.extras["spi_effective"],
                "rounds": learners.get("rounds"),
                "per_replica_steps": learners.get("per_replica_steps"),
                "resilience": result.extras.get("resilience"),
                "seconds": time.monotonic() - t0}), flush=True)
    print(json.dumps({launcher: {
        "runs": len(values), "min": min(values), "max": max(values),
        "mean": sum(values) / len(values),
        "passed": sum(v > CATCH_FLOOR for v in values),
        "at_or_below_floor": sum(v <= CATCH_FLOOR for v in values)}
        for launcher, values in finals.items()}))
    if args.device == "cuda":
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())


if __name__ == "__main__":
    main()
