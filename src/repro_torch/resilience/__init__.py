"""Fault tolerance for distributed runs (§4.2 of the paper).

Four pillars:

- ``RunCheckpointer`` — a consistent, crash-safe snapshot of an entire run
  (learner tree, replay contents, counter totals, RNG/cadence streams),
  so ``resume=True`` restarts bit for bit.
- ``RestartPolicy`` / ``classify_exit`` — the elastic-pool supervisor
  contract: worker deaths are classified (crash / preempted / shutdown)
  and ``role="worker"`` replicas respawn with exponential backoff under a
  max-restarts budget.
- ``ServiceWatchdog`` (``failover``) — the same elasticity for stateful
  ``role="service"`` nodes: periodic snapshots of every recoverable
  service (tensor leaves copied to the host once a state, ``HostTree``),
  budgeted restore on a kill, and a courier re-bind at the same address
  so the fleet's pickled handles reconnect transparently.
- ``ChaosPolicy`` — seeded fault injection (kill-after-N-steps workers,
  activity-triggered service kills, RPC delay/drop at the courier layer)
  for acceptance-testing the above.
"""
from repro_torch.checkpoint import CheckpointError, fsync_directory  # noqa: F401
from repro_torch.resilience.chaos import (ChaosPolicy,  # noqa: F401
                                          KillSchedule, RPCChaosInjector,
                                          ServiceKillSchedule)
from repro_torch.resilience.failover import (HostTree,  # noqa: F401
                                             ServiceWatchdog, atomic_pickle,
                                             is_recoverable,
                                             service_activity, supports_down)
from repro_torch.resilience.run_checkpoint import (RunCheckpointer,  # noqa: F401
                                                   RunSnapshot)
from repro_torch.resilience.supervisor import (CRASH, PREEMPTED,  # noqa: F401
                                               SHUTDOWN, RestartPolicy,
                                               classify_exit)
