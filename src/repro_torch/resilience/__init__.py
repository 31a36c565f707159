"""Fault tolerance (§4.2 of the paper): so far the run-wide snapshot.

``RunCheckpointer`` writes a consistent, crash-safe snapshot of an entire
run (learner tree, replay contents, counter totals, RNG and cadence
streams), so ``resume=True`` restarts bit for bit.  The restart policies,
service failover and chaos injection of the JAX package's
``repro.resilience`` come with distributed execution (ROADMAP slice 7).
"""
from repro_torch.checkpoint import CheckpointError, fsync_directory  # noqa: F401
from repro_torch.resilience.run_checkpoint import RunCheckpointer  # noqa: F401
