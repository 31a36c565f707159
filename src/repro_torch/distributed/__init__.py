"""Distributed execution (§2.4): Program graph + pluggable launchers.

``program`` declares the graph (nodes, roles, replicas, RPC interfaces),
``courier`` is the socket RPC layer its edges degrade to across process
boundaries (with ``RetryConfig``-governed reconnect/backoff and a typed
``ServiceUnavailable`` once a peer stays down past the deadline), and
``launchers`` holds the backend registry
(``get_launcher("local" | "multiprocess")``).  What crosses a courier edge
is pickled, so the port sends numpy there, never a tensor on a device.
"""
from repro_torch.distributed.backoff import BackoffPolicy  # noqa: F401
from repro_torch.distributed.courier import (  # noqa: F401
    RemoteError, RemoteHandle, RetryConfig, Server, ServiceUnavailable,
    serve, set_retry_config)
from repro_torch.distributed.launchers import (  # noqa: F401
    JoinTimeout, Launcher, LauncherBase, LocalLauncher, MultiprocessLauncher,
    WorkerErrors, get_launcher, register_launcher)
from repro_torch.distributed.program import (  # noqa: F401
    Handle, Node, Program, Replica)
