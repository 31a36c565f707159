"""Formal builder protocol: the typed contract every agent implements."""
from repro_torch.builders.base import AgentBuilder, BuilderOptions, registered_builders  # noqa: F401
