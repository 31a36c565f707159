"""Fault tolerance (§4.2 of the paper): so far the run-wide snapshot and
the supervisor's contract.

``RunCheckpointer`` writes a consistent, crash-safe snapshot of an entire
run (learner tree, replay contents, counter totals, RNG and cadence
streams), so ``resume=True`` restarts bit for bit.  ``classify_exit``
sorts a dead worker's exit (crash / preempted / shutdown) and
``RestartPolicy`` is the restart budget.  Service failover, elastic
respawn and chaos injection of the JAX package's ``repro.resilience`` come
with ROADMAP slice 7b.
"""
from repro_torch.checkpoint import CheckpointError, fsync_directory  # noqa: F401
from repro_torch.resilience.run_checkpoint import RunCheckpointer  # noqa: F401
from repro_torch.resilience.supervisor import (CRASH, PREEMPTED,  # noqa: F401
                                               SHUTDOWN, RestartPolicy,
                                               classify_exit)
