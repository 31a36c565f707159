"""The reference's R2D2 learning acceptance on the port
(``tests/test_agents_learning.py::test_r2d2_solves_memory_task``):
MemoryChain(memory_length=5, seed=3), the same R2D2Config, builder seed 2,
350 episodes on the CPU; the mean of the last 60 returns must beat 0.3 (a
memoryless policy gets 0 on average)."""
import numpy as np

from repro_torch.agents.builders import make_agent
from repro_torch.agents.r2d2 import R2D2Builder, R2D2Config
from repro_torch.core import EnvironmentLoop, make_environment_spec
from repro_torch.envs import MemoryChain
from torch_threads import one_torch_thread  # noqa: F401


def test_r2d2_solves_memory_task():
    env = MemoryChain(memory_length=5, seed=3)
    spec = make_environment_spec(env)
    cfg = R2D2Config(sequence_length=6, period=3, burn_in=0, batch_size=16,
                     min_replay_size=60, samples_per_insert=0,
                     target_update_period=40, epsilon=0.15)
    agent = make_agent(R2D2Builder(spec, cfg, seed=2, device="cpu"))
    loop = EnvironmentLoop(env, agent)
    rets = [loop.run_episode()["episode_return"] for _ in range(350)]
    assert int(agent.learner.state.steps) > 0
    assert np.mean(rets[-60:]) > 0.3
