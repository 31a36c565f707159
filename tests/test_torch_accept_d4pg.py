"""The reference's D4PG learning acceptance on the port
(``tests/test_agents_learning.py::test_d4pg_improves_pendulum``):
PendulumSwingup(seed=1, episode_len=120), the same ContinuousConfig (hidden
64, batch 64, min replay 300, SPI 0, n-step 3, 31 atoms over [0, 120],
sigma 0.3, a target copy every 50 steps), builder seed 3, 60 episodes on
the CPU; the mean of the last 10 returns must beat the mean of the first
10."""
import numpy as np

from repro_torch.agents.builders import make_agent
from repro_torch.agents.continuous import ContinuousBuilder, ContinuousConfig
from repro_torch.core import EnvironmentLoop, make_environment_spec
from repro_torch.envs import PendulumSwingup
from torch_threads import one_torch_thread  # noqa: F401


def test_d4pg_improves_pendulum():
    env = PendulumSwingup(seed=1, episode_len=120)
    spec = make_environment_spec(env)
    cfg = ContinuousConfig(algo="d4pg", hidden=64, batch_size=64,
                           min_replay_size=300, samples_per_insert=0,
                           n_step=3, vmin=0.0, vmax=120.0, num_atoms=31,
                           sigma=0.3, target_update_period=50)
    agent = make_agent(ContinuousBuilder(spec, cfg, seed=3, device="cpu"))
    loop = EnvironmentLoop(env, agent)
    rets = [loop.run_episode()["episode_return"] for _ in range(60)]
    assert int(agent.learner.state.steps) > 0
    assert np.mean(rets[-10:]) > np.mean(rets[:10])
