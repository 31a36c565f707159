"""The reference's R2D3 learning acceptance on the port
(``tests/test_r2d3.py::test_r2d3_learns_deep_sea_with_demos``):
DeepSea(size=5, seed=1) with 15 demonstration sequences (length 5, period
4), the same R2D3Config, builder seed 3, 250 episodes on the CPU; the
treasure must be found in more than a fifth of the last 50 episodes."""
import numpy as np

from repro_torch.agents.builders import make_agent
from repro_torch.agents.dqfd import generate_sequence_demos
from repro_torch.agents.r2d3 import R2D3Builder, R2D3Config
from repro_torch.core import EnvironmentLoop, make_environment_spec
from repro_torch.envs import DeepSea
from torch_threads import one_torch_thread  # noqa: F401


def test_r2d3_learns_deep_sea_with_demos():
    env = DeepSea(size=5, seed=1)
    spec = make_environment_spec(env)
    # period < length: overlapping sequences so the terminal (rewarding)
    # transition appears at a non-final index of some stored sequence (the
    # within-sequence TD loss bootstraps from t+1 and excludes the last slot).
    demos = generate_sequence_demos(
        DeepSea(size=5, seed=1), lambda e: e.optimal_action(),
        num_demos=15, sequence_length=5, period=4)
    assert demos and demos[0]["observation"].shape[0] == 5
    cfg = R2D3Config(sequence_length=5, period=4, burn_in=0, batch_size=16,
                     min_replay_size=40, samples_per_insert=0,
                     target_update_period=40, epsilon=0.1, demo_ratio=0.5)
    agent = make_agent(R2D3Builder(spec, demos, cfg, seed=3, device="cpu"))
    loop = EnvironmentLoop(env, agent)
    rets = [loop.run_episode()["episode_return"] for _ in range(250)]
    assert int(agent.learner.state.steps) > 0
    assert np.mean(np.asarray(rets[-50:]) > 0.5) > 0.2
