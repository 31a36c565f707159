"""Acme baseline agents (§3): value-based, actor-critic, planning, offline.

Every agent exposes a typed ``repro_torch.builders.AgentBuilder`` subclass;
importing this package registers all eight (the transformer policy's
builder registers from ``repro_torch.policies``)."""
from repro_torch.agents import bc, builders, common, continuous, dqfd, dqn, impala, mcts, r2d2, r2d3  # noqa: F401
from repro_torch.agents.builders import make_agent  # noqa: F401
