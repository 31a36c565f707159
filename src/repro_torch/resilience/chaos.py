"""Seeded chaos injection: worker kills and courier RPC faults.

A ``ChaosPolicy`` travels on ``ExperimentConfig`` and is resolved per
worker node at assembly time:

- ``schedule_for(node_name)`` yields a picklable ``KillSchedule`` for the
  targeted actor replicas.  The schedule wraps the worker's actor and
  hard-kills the process (``os._exit``) after N environment steps — the
  same failure surface as an OOM kill or a lost machine, which is exactly
  what the elastic supervisor must absorb.
- ``service_schedule_for(node_name)`` targets ``role="service"`` nodes
  (replay shards, learner replicas, the counter): the parent-side
  ``ServiceWatchdog`` polls the target's activity counter and simulates
  the death — mark_down + courier-server teardown — then restores it from
  its last snapshot under the same ``RestartPolicy`` budget.
- ``rpc_injector()`` yields an ``RPCChaosInjector`` installed at the
  courier layer inside the worker: per-call seeded delays and simulated
  connection drops, exercised *before* the request is sent so a dropped
  call is always safe to retry.

Respawned workers see ``REPRO_WORKER_RESTARTS`` (set by the launcher) and
disarm their kill schedule once ``max_kills`` deaths have been delivered —
otherwise a chaos target would kill itself fresh after every respawn and
burn the whole restart budget.
"""
from __future__ import annotations

import dataclasses
import os
import random
import sys
import threading
import time
from typing import Optional, Tuple

# Set by MultiprocessLauncher._child_main: how many times this worker has
# already been respawned (0 for the first launch).
RESTARTS_ENV = "REPRO_WORKER_RESTARTS"


def worker_restarts() -> int:
    try:
        return int(os.environ.get(RESTARTS_ENV, "0"))
    except ValueError:
        return 0


class KillSchedule:
    """Kill this process after ``kill_step`` actor steps (picklable)."""

    def __init__(self, node: str, kill_step: int, exit_code: int,
                 max_kills: int):
        if kill_step < 1:
            raise ValueError("kill_step must be >= 1")
        self.node = node
        self.kill_step = int(kill_step)
        self.exit_code = int(exit_code)
        self.max_kills = int(max_kills)
        self._count = 0

    @property
    def armed(self) -> bool:
        return worker_restarts() < self.max_kills

    def wrap(self, actor):
        if not self.armed:
            return actor
        return _ChaosActor(actor, self)

    def tick(self):
        self._count += 1
        if self._count >= self.kill_step:
            print(f"[chaos] {self.node}: killing worker after "
                  f"{self._count} steps (exit {self.exit_code})",
                  file=sys.stderr, flush=True)
            # A real kill, not an exception: no cleanup, no error-queue
            # report — the supervisor must notice the silent death.
            os._exit(self.exit_code)


class ServiceKillSchedule:
    """Kill a parent-resident service once its activity passes a threshold.

    Services have no process of their own and no ``observe()`` hook to
    wrap, so the trigger is the service's OWN progress counter
    (``repro_torch.resilience.failover.service_activity``: replay inserts +
    samples, learner-replica steps, counter totals) polled by the
    ``ServiceWatchdog``, which then simulates the death (mark_down +
    courier-server teardown) and the budgeted restore.
    """

    def __init__(self, node: str, kill_step: int, exit_code: int,
                 max_kills: int):
        if kill_step < 1:
            raise ValueError("kill_step must be >= 1")
        self.node = node
        self.kill_step = int(kill_step)
        self.exit_code = int(exit_code)
        self.max_kills = int(max_kills)
        self.fired = 0  # kills delivered (the watchdog's disarm counter)


class _ChaosActor:
    """Actor wrapper counting environment steps via ``observe`` calls."""

    def __init__(self, actor, schedule: KillSchedule):
        self._actor = actor
        self._schedule = schedule

    def observe(self, *args, **kwargs):
        result = self._actor.observe(*args, **kwargs)
        self._schedule.tick()
        return result

    def __getattr__(self, name):
        return getattr(self._actor, name)


class RPCChaosInjector:
    """Courier-layer fault injection, consulted client-side before send."""

    def __init__(self, delay_ms: float = 0.0, drop_rate: float = 0.0,
                 seed: int = 0):
        self.delay_ms = float(delay_ms)
        self.drop_rate = float(drop_rate)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected = {"delays": 0, "drops": 0}

    def before_send(self):
        """Sleep (delay) and/or raise ``ConnectionError`` (drop).  Runs
        before any bytes hit the socket, so retrying is always safe."""
        with self._lock:
            delay = self.delay_ms if self.delay_ms > 0 else 0.0
            drop = (self.drop_rate > 0
                    and self._rng.random() < self.drop_rate)
            if delay:
                self.injected["delays"] += 1
            if drop:
                self.injected["drops"] += 1
        if delay:
            time.sleep(delay / 1000.0)
        if drop:
            raise ConnectionError("chaos: injected RPC drop")

    def install(self):
        from repro_torch.distributed import courier
        courier.set_rpc_chaos(self)


@dataclasses.dataclass(frozen=True)
class ChaosPolicy:
    """Declarative, seeded fault schedule for a run.

    ``kill_targets`` name program nodes (e.g. ``("actor/0",)``); each gets
    a kill after ``kill_after_steps`` actor steps, plus a deterministic
    per-node jitter of up to ``kill_jitter_steps`` drawn from ``seed``.
    ``max_kills`` bounds deaths per target across respawns.  RPC faults
    apply to every courier client in the targeted workers.
    """

    kill_after_steps: Optional[int] = None
    kill_targets: Tuple[str, ...] = ()
    kill_jitter_steps: int = 0
    kill_exit_code: int = 42          # positive → classified as a crash
    max_kills: int = 1
    rpc_delay_ms: float = 0.0
    rpc_drop_rate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.kill_after_steps is not None and self.kill_after_steps < 1:
            raise ValueError("kill_after_steps must be >= 1")
        if not 0.0 <= self.rpc_drop_rate < 1.0:
            raise ValueError("rpc_drop_rate must be in [0, 1)")
        if self.rpc_delay_ms < 0:
            raise ValueError("rpc_delay_ms must be >= 0")
        if self.kill_exit_code <= 0:
            raise ValueError("kill_exit_code must be > 0 (a crash)")

    def schedule_for(self, node: str) -> Optional[KillSchedule]:
        if self.kill_after_steps is None or node not in self.kill_targets:
            return None
        jitter = 0
        if self.kill_jitter_steps > 0:
            # str seeding hashes via sha512 — stable across processes,
            # unlike tuple hashing (PYTHONHASHSEED-randomized)
            rng = random.Random(f"{self.seed}/{node}")
            jitter = rng.randint(0, self.kill_jitter_steps)
        return KillSchedule(node, self.kill_after_steps + jitter,
                            self.kill_exit_code, self.max_kills)

    def service_schedule_for(self, node: str) -> Optional[ServiceKillSchedule]:
        """Like ``schedule_for`` but for ``role="service"`` nodes — same
        targeting, jitter, and budget; different delivery (watchdog-polled
        activity instead of a wrapped actor)."""
        if self.kill_after_steps is None or node not in self.kill_targets:
            return None
        jitter = 0
        if self.kill_jitter_steps > 0:
            rng = random.Random(f"{self.seed}/{node}")
            jitter = rng.randint(0, self.kill_jitter_steps)
        return ServiceKillSchedule(node, self.kill_after_steps + jitter,
                                   self.kill_exit_code, self.max_kills)

    def rpc_injector(self) -> Optional[RPCChaosInjector]:
        if self.rpc_delay_ms <= 0 and self.rpc_drop_rate <= 0:
            return None
        return RPCChaosInjector(self.rpc_delay_ms, self.rpc_drop_rate,
                                self.seed)
