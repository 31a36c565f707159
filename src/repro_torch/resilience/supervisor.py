"""Worker-death classification and restart budgets for elastic pools.

The ``MultiprocessLauncher`` monitor consults this module when a child
process dies: the exit is classified, and — when a ``RestartPolicy`` is
attached to the program and the dead node is a ``role="worker"`` replica —
the worker is respawned with exponential backoff instead of failing the
whole run.  Stateful ``role="service"`` nodes (replay shards, counter,
learner replicas) are covered by the same policy through
``repro_torch.resilience.failover.ServiceWatchdog``: their deaths are classified
with the same ``classify_exit`` and charged against the same per-node
budget, but a respawn RESTORES the service's periodic snapshot and
re-binds its courier server at the same address (workers respawn fresh
from their spawn payloads — they are stateless by design).  A service
whose budget is exhausted stays fail-fast.

Classification:

- ``SHUTDOWN`` — exit code 0, or any death while a stop was already in
  flight.  Never restarted.
- ``PREEMPTED`` — killed by a signal (negative exit code): the scheduler
  took the machine back.  Restartable.
- ``CRASH`` — any other nonzero exit: the worker itself failed.
  Restartable (up to the budget), because single-worker crashes in a
  fleet are routine (OOM, flaky env) and the learner stream must survive
  them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

CRASH = "crash"
PREEMPTED = "preempted"
SHUTDOWN = "shutdown"


def classify_exit(exitcode: Optional[int], *, stopping: bool = False) -> str:
    """Classify a dead worker's exit code.

    ``stopping`` marks deaths observed after the launcher initiated its own
    stop — those are shutdown noise regardless of the code (a worker killed
    mid-RPC can die nonzero during teardown).
    """
    if stopping or exitcode == 0:
        return SHUTDOWN
    if exitcode is not None and exitcode < 0:
        return PREEMPTED
    return CRASH


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """How the supervisor respawns dead nodes (worker replicas and, via the
    service watchdog, stateful services).

    ``max_restarts`` is a PER-NODE budget; once a node exhausts it, its
    next death is fail-fast (the run stops).
    Backoff for restart number k (0-based) is
    ``min(backoff_base_s * backoff_factor**k, backoff_max_s)``.
    """

    max_restarts: int = 3
    backoff_base_s: float = 0.1
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    restart_on: Tuple[str, ...] = (CRASH, PREEMPTED)

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff durations must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1.0")
        for kind in self.restart_on:
            if kind not in (CRASH, PREEMPTED, SHUTDOWN):
                raise ValueError(f"unknown exit kind {kind!r}")

    def backoff(self, restart_index: int) -> float:
        return min(self.backoff_base_s * self.backoff_factor ** restart_index,
                   self.backoff_max_s)

    def should_restart(self, kind: str, restarts_so_far: int) -> bool:
        return kind in self.restart_on and restarts_so_far < self.max_restarts
