"""Shared jittered-exponential-backoff policy for retry loops.

One helper, two consumers (both in ``repro_torch.distributed.courier``): the
idempotent-retry path (response lost after a request was sent) and the
reconnect path (connection refused/reset during a service's restart
window).  Delays grow geometrically from ``base_s`` up to ``max_s`` and
are jittered DOWNWARD — ``delay`` is drawn uniformly from
``[(1 - jitter) * full, full]`` — so a fleet of clients stampeding a
restarting service decorrelates without ever waiting longer than the
deterministic schedule.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Jittered exponential backoff: ``min(base * factor**attempt, max)``."""

    base_s: float = 0.05
    factor: float = 2.0
    max_s: float = 2.0
    jitter: float = 0.5  # fraction of the delay that may be shaved off

    def __post_init__(self):
        if self.base_s < 0:
            raise ValueError(f"base_s must be >= 0, got {self.base_s}")
        if self.factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {self.factor}")
        if self.max_s < 0:
            raise ValueError(f"max_s must be >= 0, got {self.max_s}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Delay in seconds before retry number ``attempt`` (0-indexed)."""
        full = min(self.base_s * self.factor ** max(attempt, 0), self.max_s)
        if not self.jitter or full <= 0:
            return full
        draw = (rng or random).random()
        return full * (1.0 - self.jitter * draw)
