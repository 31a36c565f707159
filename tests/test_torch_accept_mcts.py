"""The reference's MCTS acceptance on the port
(``tests/test_agents_learning.py::test_mcts_actor_plans_catch``):
Catch(seed=4), 48 simulations, depth 12, temperature 0.25, the actor's
weights from ``make_network``'s init at seed 0 behind a
``VariableServer``, the real env as its model; with a perfect simulator
and pure search the mean return over 10 episodes must beat 0.4.  Then a
few episodes of the agent that ``make_agent`` builds from ``MCTSBuilder``,
whose learner must step."""
import numpy as np
import torch

from repro_torch.agents.builders import make_agent
from repro_torch.agents.mcts import (MCTSActor, MCTSBuilder, MCTSConfig,
                                     make_network)
from repro_torch.core import (EnvironmentLoop, VariableClient,
                              make_environment_spec)
from repro_torch.core.variable import VariableServer
from repro_torch.envs import Catch
from torch_threads import one_torch_thread  # noqa: F401


def test_mcts_actor_plans_catch():
    env = Catch(seed=4)
    spec = make_environment_spec(env)
    cfg = MCTSConfig(num_simulations=48, search_depth=12, temperature=0.25)
    init, _, _, _ = make_network(spec, cfg, device="cpu")
    server = VariableServer(policy=init(torch.Generator().manual_seed(0)))
    actor = MCTSActor(spec, cfg, VariableClient(server), model_env=env,
                      seed=0, device="cpu")
    rets = []
    for _ in range(10):
        ts = env.reset()
        total = 0.0
        while not ts.last():
            a = actor.select_action(ts.observation)
            ts = env.step(a)
            total += ts.reward
        rets.append(total)
    assert np.mean(rets) > 0.4


def test_mcts_agent_runs_and_its_learner_steps():
    env = Catch(seed=0)
    # one padded 10-step sequence an episode: learning starts at 4
    cfg = MCTSConfig(num_simulations=8, search_depth=6, batch_size=4,
                     min_replay_size=4)
    agent = make_agent(MCTSBuilder(make_environment_spec(env),
                                   lambda seed: Catch(seed=seed), cfg,
                                   seed=0, device="cpu"))
    loop = EnvironmentLoop(env, agent)
    rets = [loop.run_episode()["episode_return"] for _ in range(12)]
    assert int(agent.learner.state.steps) > 0
    assert np.isfinite(rets).all()
