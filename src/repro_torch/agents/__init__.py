"""Acme baseline agents (§3).  Every agent exposes a typed
``repro_torch.builders.AgentBuilder`` subclass; importing this package
registers them.  Ported so far: IMPALA, DQN, R2D2, DQfD and R2D3 (the
transformer policy's builder registers from ``repro_torch.policies``)."""
from repro_torch.agents import builders, common, dqfd, dqn, impala, r2d2, r2d3  # noqa: F401
from repro_torch.agents.builders import make_agent  # noqa: F401
