"""Repeat the reference's two-replica DQN acceptance on the port and print
each run's final eval.

The acceptance (``tests/test_multi_learner.py::
test_two_replica_dqn_on_catch_learns``: conftest's DQN preset on Catch,
seed 0, 2 actors, 2 learner replicas averaging every 10 steps, 4000 actor
steps, 20 eval episodes, final eval > -0.6) runs asynchronously, so its
outcome depends on how the threads or processes interleave.  This script
runs it ``--runs`` times on each launcher asked for and prints one JSON
line a run, then a summary: how often it fell to the floor or below.

    PYTHONPATH=src python scripts/acceptance_repeats.py --runs 10 \\
        --device cuda --launchers local multiprocess

The work stays under ``__main__`` and the builder factory is at module
level: the multiprocess launcher's children re-import this file.
"""
import argparse
import json
import time

CATCH_FLOOR = -0.6
DQN_SMOKE = dict(min_replay_size=50, samples_per_insert=4.0, batch_size=16,
                 n_step=1, epsilon=0.2)


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--launchers", nargs="+",
                        default=["local", "multiprocess"])
    args = parser.parse_args()

    import torch

    from repro_torch.experiments import (ExperimentConfig,
                                         run_distributed_experiment)
    if args.device == "cpu":
        torch.set_num_threads(1)
    finals = {launcher: [] for launcher in args.launchers}
    for _ in range(args.runs):
        for launcher in args.launchers:
            config = ExperimentConfig(
                builder_factory=DQNFactory(args.device),
                environment_factory=catch_env, seed=0, eval_episodes=20,
                launcher=launcher, num_learner_replicas=2,
                learner_average_period=10)
            t0 = time.monotonic()
            result = run_distributed_experiment(config, num_actors=2,
                                                max_actor_steps=4000,
                                                timeout_s=240)
            finals[launcher].append(result.final_eval_return)
            print(json.dumps({
                "launcher": launcher, "device": args.device,
                "final_eval": result.final_eval_return,
                "learner_steps": result.learner_steps,
                "rounds": result.extras["learners"]["rounds"],
                "seconds": time.monotonic() - t0}), flush=True)
    print(json.dumps({launcher: {
        "runs": len(values), "min": min(values), "max": max(values),
        "mean": sum(values) / len(values),
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
