"""Acme's core: actors, learners, agents, environment loops, variable flow."""
from repro_torch.builders import AgentBuilder, BuilderOptions  # noqa: F401
from repro_torch.core.actors import (  # noqa: F401
    BatchedFeedForwardActor, BatchedRecurrentActor, FeedForwardActor,
    InferenceClientActor, RecurrentActor)
from repro_torch.core.agent import Agent  # noqa: F401
from repro_torch.core.inference import INFERENCE_INTERFACE, InferenceServer  # noqa: F401
from repro_torch.core.interfaces import Actor, Learner, VariableSource, Worker  # noqa: F401
from repro_torch.core.loop import (  # noqa: F401
    Counter, EnvironmentLoop, VectorizedEnvironmentLoop)
from repro_torch.core.types import (  # noqa: F401
    ArraySpec, BoundedArraySpec, DiscreteArraySpec, Environment,
    EnvironmentSpec, StepType, TimeStep, Transition, make_environment_spec,
    restart, termination, transition, truncation)
from repro_torch.core.variable import VariableClient, VariableServer  # noqa: F401
