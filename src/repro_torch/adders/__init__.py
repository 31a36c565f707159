"""Adders (§2.3): the insertion-side pre-processing between actor and
table."""
from repro_torch.adders.base import Adder  # noqa: F401
from repro_torch.adders.sequence import EpisodeAdder, SequenceAdder  # noqa: F401
from repro_torch.adders.transition import NStepTransitionAdder, TransitionAdder  # noqa: F401
