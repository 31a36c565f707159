"""The reference's DQfD learning acceptance on the port
(``tests/test_agents_learning.py::test_dqfd_uses_demos_on_deep_sea``):
DeepSea(size=6, seed=1) with 20 optimal demonstrations, the same
DQfDConfig, builder seed 0, 250 episodes on the CPU; the treasure must be
found in more than a fifth of the last 50 episodes (a random policy finds
it with probability 2^-6)."""
import numpy as np

from repro_torch.agents.builders import make_agent
from repro_torch.agents.dqfd import (DQfDBuilder, DQfDConfig,
                                     generate_deep_sea_demos)
from repro_torch.core import EnvironmentLoop, make_environment_spec
from repro_torch.envs import DeepSea
from torch_threads import one_torch_thread  # noqa: F401


def test_dqfd_uses_demos_on_deep_sea():
    env = DeepSea(size=6, seed=1)
    spec = make_environment_spec(env)
    demos = generate_deep_sea_demos(DeepSea(size=6, seed=1), num_demos=20)
    assert len(demos) > 0
    cfg = DQfDConfig(min_replay_size=60, samples_per_insert=0, batch_size=32,
                     n_step=1, demo_ratio=0.5, epsilon=0.1)
    agent = make_agent(DQfDBuilder(spec, demos, cfg, seed=0, device="cpu"))
    loop = EnvironmentLoop(env, agent)
    rets = [loop.run_episode()["episode_return"] for _ in range(250)]
    assert np.mean(np.asarray(rets[-50:]) > 0.5) > 0.2
