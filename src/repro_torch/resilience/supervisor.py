"""Worker-death classification and restart budgets for elastic pools.

The ``MultiprocessLauncher`` monitor classifies every child death with
``classify_exit``.  ``RestartPolicy`` is the budget an elastic launcher
respawns dead ``role="worker"`` replicas under (and, with service failover,
restores stateful ``role="service"`` nodes under); elastic supervision
comes with that failover (ROADMAP slice 7b), and until then the launchers
refuse a program that carries a policy.

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
