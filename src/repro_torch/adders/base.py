"""Adders (§2.3): the insertion-side pre-processing between actor and table."""
from __future__ import annotations

import abc
from typing import Any, Optional

from repro_torch.core.types import TimeStep


class Adder(abc.ABC):
    # Subclasses whose add_first accepts a second ``extras`` argument
    # (recurrent core state at sequence starts) declare
    # ``supports_extras = True``; ``supports_extras = False`` explicitly
    # opts out.  Deliberately NOT defaulted here: an inherited default would
    # shadow the ``inspect.signature`` arity fallback in
    # ``repro_torch.core.actors.adder_takes_extras`` for adders that predate the
    # flag.  Actors must use that helper — never probe by calling add_first
    # inside try/except TypeError, which masks real TypeErrors raised in
    # the adder.

    @abc.abstractmethod
    def add_first(self, timestep: TimeStep):
        ...

    @abc.abstractmethod
    def add(self, action, next_timestep: TimeStep, extras: Any = ()):
        ...

    def reset(self):
        pass
