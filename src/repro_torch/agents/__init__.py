"""Acme baseline agents (§3).  Every agent exposes a typed
``repro_torch.builders.AgentBuilder`` subclass; importing this package
registers them.  Ported so far: IMPALA and DQN."""
from repro_torch.agents import builders, common, dqn, impala  # noqa: F401
from repro_torch.agents.builders import make_agent  # noqa: F401
