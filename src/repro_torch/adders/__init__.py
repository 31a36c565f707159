"""Adders (§2.3).  The transition adders come with the DQN slice."""
from repro_torch.adders.base import Adder  # noqa: F401
from repro_torch.adders.sequence import EpisodeAdder, SequenceAdder  # noqa: F401
