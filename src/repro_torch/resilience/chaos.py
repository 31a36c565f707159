"""Chaos injection's launcher contract.

Only the environment variable the ``MultiprocessLauncher`` publishes in
each spawned worker is here so far; the seeded kill schedules and courier
RPC faults come with service failover (ROADMAP slice 7b).
"""

# Set by MultiprocessLauncher._child_main: how many times this worker has
# already been respawned (0 for the first launch).
RESTARTS_ENV = "REPRO_WORKER_RESTARTS"
