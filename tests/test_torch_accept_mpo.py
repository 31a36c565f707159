"""The reference's MPO and DMPO run-and-update checks on the port
(``tests/test_agents_learning.py::test_mpo_runs_and_updates`` and
``::test_dmpo_runs_and_updates``): PendulumSwingup(episode_len=60) at each
check's config and seeds, 12 episodes on the CPU; the learner steps and
every return is finite."""
import numpy as np
import pytest

from repro_torch.agents.builders import make_agent
from repro_torch.agents.continuous import ContinuousBuilder, ContinuousConfig
from repro_torch.core import EnvironmentLoop, make_environment_spec
from repro_torch.envs import PendulumSwingup
from torch_threads import one_torch_thread  # noqa: F401

CHECKS = {
    "mpo": (2, 4, dict(algo="mpo", hidden=32, batch_size=32,
                       min_replay_size=120, samples_per_insert=0,
                       mpo_samples=8, target_update_period=25)),
    "dmpo": (5, 5, dict(algo="dmpo", hidden=32, batch_size=32,
                        min_replay_size=120, samples_per_insert=0,
                        mpo_samples=8, vmin=0.0, vmax=60.0, num_atoms=21)),
}


@pytest.mark.parametrize("algo", CHECKS)
def test_runs_and_updates(algo):
    env_seed, builder_seed, knobs = CHECKS[algo]
    env = PendulumSwingup(seed=env_seed, episode_len=60)
    spec = make_environment_spec(env)
    agent = make_agent(ContinuousBuilder(spec, ContinuousConfig(**knobs),
                                         seed=builder_seed, device="cpu"))
    loop = EnvironmentLoop(env, agent)
    rets = [loop.run_episode()["episode_return"] for _ in range(12)]
    assert int(agent.learner.state.steps) > 0
    assert np.isfinite(rets).all()
