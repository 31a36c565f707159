"""Acme's core: specs, interfaces, the environment loop, variable flow and
the batching server (the parts the policy-serving slice needs)."""
from repro_torch.core.interfaces import Actor, Learner, VariableSource, Worker  # noqa: F401
from repro_torch.core.loop import Counter, EnvironmentLoop  # noqa: F401
from repro_torch.core.types import (  # noqa: F401
    ArraySpec, BoundedArraySpec, DiscreteArraySpec, Environment,
    EnvironmentSpec, StepType, TimeStep, Transition, make_environment_spec,
    restart, termination, transition, truncation)
from repro_torch.core.variable import VariableClient  # noqa: F401
