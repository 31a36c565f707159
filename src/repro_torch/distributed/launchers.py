"""Pluggable launcher backends for the Program graph (§2.4).

A ``Launcher`` turns a declared ``Program`` into running nodes.  The
protocol is four calls — ``launch`` / ``stop`` / ``join`` / ``should_stop``
— plus ``serve`` (export a node over courier RPC).  Backends register under
a name (``register_launcher``) and are selected with ``get_launcher``;
``ExperimentConfig.launcher`` flows that name through
``run_distributed_experiment`` so the same agent graph runs on either
backend with zero agent-side edits:

- ``"local"``   — every node in this process; workers (and runnable
  services, e.g. the learner) on threads.  Zero-overhead edges.
- ``"multiprocess"`` — each worker node in its own OS process (spawn
  context).  Service nodes stay in the parent wrapped in courier servers;
  pickling a worker's arguments converts its ``Handle`` edges into
  ``RemoteHandle`` RPC stubs bound to those servers.

Shared semantics (the launcher conformance suite in
``tests/test_distributed.py`` enforces these for every backend):

- **Fail-fast**: the first worker failure stops every sibling node; all
  failures are aggregated into ``WorkerErrors`` (a single failure re-raises
  as itself).
- **Shutdown-noise classification**: errors raised after the user requested
  shutdown — and rate-limiter wakeups caused by stopping replay tables
  (``RateLimiterTimeout``, whether raised in-process or carried back over
  courier) — are suppressed, not surfaced.
- **Join timeout**: ``join(timeout)`` that expires with nodes still running
  raises ``JoinTimeout`` naming them (folded into ``WorkerErrors`` when
  real failures were also collected) instead of returning silently.
- ``stop``/``join`` are idempotent.

Registering a new backend::

    class FleetLauncher(LauncherBase):
        backend = "fleet"
        requires_pickling = True      # node args must survive pickling
        def launch(self): ...
    register_launcher("fleet", FleetLauncher)
"""
from __future__ import annotations

import abc
import pickle
import threading
import time
from typing import Dict, List, Optional, Type

from repro_torch.distributed.courier import RemoteHandle, Server, picklable_error
from repro_torch.distributed.program import Node, Program
from repro_torch.resilience.chaos import RESTARTS_ENV
from repro_torch.resilience.supervisor import classify_exit


class WorkerErrors(RuntimeError):
    """Aggregate of every worker failure in a launched program (3.10-era
    stand-in for ExceptionGroup) — no error is silently dropped."""

    def __init__(self, errors: List[BaseException]):
        self.errors = list(errors)
        summary = "; ".join(f"[{i}] {type(e).__name__}: {e}"
                            for i, e in enumerate(self.errors))
        super().__init__(
            f"{len(self.errors)} worker(s) failed: {summary}")


class JoinTimeout(RuntimeError):
    """``join(timeout)`` expired while nodes were still running."""

    def __init__(self, node_names: List[str], timeout: Optional[float]):
        self.node_names = list(node_names)
        self.timeout = timeout
        super().__init__(
            f"join(timeout={timeout}) expired with {len(self.node_names)} "
            f"node(s) still running: {', '.join(self.node_names)}")


class Launcher(abc.ABC):
    """The backend protocol every launcher implements."""

    backend: str = ""
    # Whether worker-node factories/args must survive pickling (process- or
    # host-crossing backends).  Assembly layers use this to decide between
    # sharing rich in-memory objects and shipping picklable factories.
    requires_pickling: bool = False

    @abc.abstractmethod
    def launch(self) -> "Launcher":
        """Start every node; returns self."""

    @abc.abstractmethod
    def stop(self):
        """Request shutdown of every node (user-initiated, idempotent)."""

    @abc.abstractmethod
    def join(self, timeout: Optional[float] = None):
        """Wait for all nodes; raise collected failures / ``JoinTimeout``."""

    @abc.abstractmethod
    def should_stop(self) -> bool:
        """True once a stop (user- or fail-fast-initiated) is in flight."""


class LauncherBase(Launcher):
    """Shared machinery: parent-side node threads, fail-fast error
    collection, shutdown-noise classification, courier serving, join."""

    def __init__(self, program: Program):
        self.program = program
        self.threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._user_stopped = False
        self._errors: List[BaseException] = []
        self._errors_lock = threading.Lock()
        self._servers: Dict[str, Server] = {}

    # ------------------------------------------------------------- courier
    def serve(self, name: str) -> RemoteHandle:
        """Export node ``name`` over a courier server (idempotent) and
        return a picklable ``RemoteHandle`` to it."""
        if name not in self._servers:
            node = self.program.node(name)
            instance = self.program.resolve(name)
            server = Server(instance, interface=node.interface,
                            name=name).start()
            self._servers[name] = server
            self.program.bind_courier(name, server.address, server.authkey)
        server = self._servers[name]
        return RemoteHandle(server.address, name=name,
                            interface=server.interface,
                            authkey=server.authkey)

    def _close_servers(self):
        for server in self._servers.values():
            server.stop()

    # ------------------------------------------------------- parent threads
    def _runs_in_parent_thread(self, node: Node) -> bool:
        """Workers run on parent threads by default; so do services whose
        instance has a run loop (the learner: steps SGD *and* serves)."""
        if node.is_worker:
            return True
        return callable(getattr(node.instance, "run", None))

    def _start_parent_thread(self, node: Node):
        node.placement = "thread"
        t = threading.Thread(target=self._run_node, args=(node,),
                             name=node.name, daemon=True)
        self.threads.append(t)
        t.start()

    def _run_node(self, node: Node):
        try:
            node.instance.run()
        except StopIteration:
            pass
        except Exception as e:
            if self._classify_as_shutdown_noise(e):
                return
            self._record_error(e)

    def _classify_as_shutdown_noise(self, e: BaseException) -> bool:
        """Once a stop is in flight (user- or fail-fast-initiated — the flag
        is always set before any table is stopped), rate-limiter wakeups are
        shutdown noise, as are connection teardowns (a stopped
        ``InferenceServer`` wakes blocked ``select_action`` callers with
        ``CourierClosed`` — mirroring the child-side classifier) and
        anything raised after the user asked us to shut down.  A "stopped"
        error with no stop in flight is a real worker death and must be
        surfaced."""
        from repro_torch.replay.rate_limiter import RateLimiterTimeout
        return self._stop.is_set() and (
            self._user_stopped
            or isinstance(e, (RateLimiterTimeout, ConnectionError)))

    def _record_error(self, e: BaseException):
        with self._errors_lock:
            self._errors.append(e)
        # fail fast: stop the siblings so join() returns promptly
        self._initiate_stop()

    # ---------------------------------------------------------------- stop
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def _initiate_stop(self):
        self._stop.set()
        for node in self.program.nodes:
            inst = node.instance
            if inst is not None and hasattr(inst, "stop"):
                try:
                    inst.stop()
                except Exception:
                    pass

    def stop(self):
        self._user_stopped = True
        self._initiate_stop()

    # ---------------------------------------------------------------- join
    def _join_runners(self, deadline: Optional[float]):
        for t in self.threads:
            remaining = (None if deadline is None
                         else max(deadline - time.time(), 0))
            t.join(remaining)

    def _alive_nodes(self) -> List[str]:
        return [t.name for t in self.threads if t.is_alive()]

    def _reap_stragglers(self, names: List[str]):
        """Forcibly clean up nodes that survived the join timeout (threads
        cannot be killed — they are daemonic — but process backends
        override this to terminate children)."""

    def join(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.time() + timeout
        self._join_runners(deadline)
        with self._errors_lock:
            errors = list(self._errors)
        alive = self._alive_nodes()
        if alive:
            # do not leak: the stragglers are reaped (where possible) and
            # reported by name — a retried join() then returns cleanly.
            errors.append(JoinTimeout(alive, timeout))
            self._reap_stragglers(alive)
        self._close_servers()
        if len(errors) == 1:
            raise errors[0]
        if errors:
            raise WorkerErrors(errors)


class LocalLauncher(LauncherBase):
    """Every node in this process: the single-machine backend.

    Workers (and runnable services) run on daemon threads; edges stay
    in-memory ``Handle``s — zero serialization, zero RPC overhead.
    """

    backend = "local"
    requires_pickling = False

    def launch(self) -> "LocalLauncher":
        # construct everything first (resolves the graph edges)
        for node in self.program.nodes:
            self.program.resolve(node.name)
        for node in self.program.nodes:
            if self._runs_in_parent_thread(node):
                self._start_parent_thread(node)
        return self


def _child_watch_stop(control_pipe, instance, flags):
    """Wait for the parent's stop message and relay it to the node.

    A pipe, not a shared multiprocessing.Event: a child dying mid-wait on a
    shared Event corrupts its Condition handshake and deadlocks the parent's
    set(); a dead pipe end just raises EOFError.  Parent death reads as a
    (user-style) stop so orphans shut down quietly.
    """
    try:
        msg = control_pipe.recv()
        user = bool(msg[1]) if isinstance(msg, tuple) and len(msg) > 1 \
            else False
    except (EOFError, OSError):
        user = True
    flags["user"] = flags["user"] or user
    flags["stop"] = True
    if hasattr(instance, "stop"):
        try:
            instance.stop()
        except Exception:
            pass


def _child_classify_noise(e, flags) -> bool:
    """Child-side mirror of the parent's shutdown-noise classification.
    Courier re-raises remote exceptions with their original type, so a
    ``RateLimiterTimeout`` from a parent-hosted replay table classifies
    identically here; connection teardown during shutdown is also noise."""
    from repro_torch.replay.rate_limiter import RateLimiterTimeout
    if isinstance(e, (RateLimiterTimeout, ConnectionError)) \
            and not flags["stop"]:
        # the stop message may still be in flight on the control pipe while
        # the stopped table's wakeup raced ahead over courier — give the
        # watcher a beat before declaring a real worker death.
        deadline = time.time() + 1.0
        while not flags["stop"] and time.time() < deadline:
            time.sleep(0.02)
    if not flags["stop"]:
        return False
    return (flags["user"]
            or isinstance(e, (RateLimiterTimeout, ConnectionError)))


def _child_main(node_name, payload, control_pipe, error_queue,
                torch_threads):
    """Entry point of a spawned worker process: rebuild the node from its
    pickled (factory, args, kwargs) — Handles arrive as RemoteHandles — and
    drive its run loop until done or stopped.

    The child runs torch on ``torch_threads`` intra-op threads, its
    parent's count: a fresh interpreter would otherwise start one a core,
    and a fleet of children on one host would oversubscribe it.  How many
    times the worker was respawned is published via ``RESTARTS_ENV``
    before the node is built: 0, until elastic respawn (slice 7b).
    """
    import faulthandler
    import os
    import signal
    import sys

    import torch
    # SIGUSR1 dumps every thread's stack to stderr — the only way to see
    # where a live worker is stuck from outside.
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    os.environ[RESTARTS_ENV] = "0"
    torch.set_num_threads(torch_threads)
    flags = {"stop": False, "user": False}
    try:
        factory, args, kwargs = pickle.loads(payload)
        instance = factory(*args, **kwargs)
    except Exception as e:   # constructor failure is a worker failure
        error_queue.put((node_name, picklable_error(e)))
        sys.exit(1)
    threading.Thread(target=_child_watch_stop,
                     args=(control_pipe, instance, flags),
                     daemon=True).start()
    try:
        instance.run()
    except StopIteration:
        pass
    except Exception as e:
        if _child_classify_noise(e, flags):
            sys.exit(0)
        error_queue.put((node_name, picklable_error(e)))
        sys.exit(1)


class MultiprocessLauncher(LauncherBase):
    """Each worker node in its own OS process (spawn context).

    Service nodes are resolved in the parent and exported over courier;
    pickling a worker's arguments rewrites its ``Handle`` edges into
    ``RemoteHandle`` stubs bound to those servers (``Handle.__reduce__``),
    so node code is byte-identical across backends.  Child failures flow
    back through an error queue into the parent's fail-fast stop, with the
    same ``WorkerErrors`` aggregation and shutdown-noise rules as
    ``LocalLauncher``; every child death is classified with
    ``classify_exit``.  Elastic respawn under a program's
    ``restart_policy`` comes with service failover (ROADMAP slice 7b):
    ``launch`` refuses such a program until then.
    """

    backend = "multiprocess"
    requires_pickling = True

    def __init__(self, program: Program):
        super().__init__(program)
        import multiprocessing
        self._ctx = multiprocessing.get_context("spawn")
        self._error_queue = self._ctx.Queue()
        self.processes: Dict[str, object] = {}
        self._control_pipes: Dict[str, object] = {}
        self._reported: set = set()
        self._exit_kinds: Dict[str, List[str]] = {}
        self._monitor_thread: Optional[threading.Thread] = None

    def restart_stats(self) -> Dict:
        """Supervisor bookkeeping: the classification of every death
        observed (no worker is restarted yet)."""
        return {"restarts": {},
                "exit_kinds": {k: list(v)
                               for k, v in self._exit_kinds.items()}}

    def launch(self) -> "MultiprocessLauncher":
        if self.program.restart_policy is not None:
            raise NotImplementedError(
                "MultiprocessLauncher: a program with a restart_policy needs "
                "elastic supervision and service failover, which are not "
                "ported yet (ROADMAP slice 7b)")
        try:
            # 1. services live in the parent, exported over courier.
            for node in self.program.nodes:
                if node.role == "service":
                    self.serve(node.name)
            # 2. runnable services (the learner) get parent threads.
            for node in self.program.nodes:
                if node.role == "service" \
                        and self._runs_in_parent_thread(node):
                    self._start_parent_thread(node)
            # 3. workers spawn as OS processes; pickling converts Handles.
            for node in self.program.nodes:
                if not node.is_worker:
                    continue
                node.placement = "process"
                try:
                    payload = pickle.dumps(
                        (node.factory, node.args, node.kwargs),
                        protocol=pickle.HIGHEST_PROTOCOL)
                except Exception as e:
                    raise RuntimeError(
                        f"worker node {node.name!r} cannot be placed in a "
                        f"child process: its factory/arguments failed to "
                        f"pickle ({type(e).__name__}: {e}). Use module-level "
                        f"factories and pass services as Handles.") from e
                self._spawn(node.name, payload)
        except BaseException:
            # a half-launched program must not leak: children already
            # spawned would keep training against it for the parent's
            # lifetime, and the courier servers would hold their sockets.
            self._abort_launch()
            raise
        self._monitor_thread = threading.Thread(target=self._monitor,
                                                name="launcher/monitor",
                                                daemon=True)
        self._monitor_thread.start()
        return self

    def _spawn(self, name: str, payload: bytes):
        """Start worker ``name`` from its pickled payload."""
        import torch
        parent_end, child_end = self._ctx.Pipe()
        self._control_pipes[name] = parent_end
        proc = self._ctx.Process(
            target=_child_main,
            args=(name, payload, child_end, self._error_queue,
                  torch.get_num_threads()),
            name=name, daemon=True)
        self.processes[name] = proc
        proc.start()
        child_end.close()   # parent keeps only its own end

    def _abort_launch(self):
        self.stop()
        for proc in list(self.processes.values()):
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
        self._close_servers()

    # ------------------------------------------------------------- monitor
    def _drain_errors(self):
        import queue as queue_lib
        while True:
            try:
                name, exc = self._error_queue.get_nowait()
            except (queue_lib.Empty, OSError, EOFError):
                return
            self._reported.add(name)
            self._record_error(exc)

    def _handle_death(self, name: str, proc):
        """Classify a dead worker and surface a failure it did not report
        itself (fail-fast)."""
        kind = classify_exit(proc.exitcode, stopping=self._stop.is_set())
        self._exit_kinds.setdefault(name, []).append(kind)
        suppress = self._stop.is_set() and self._user_stopped
        if (proc.exitcode not in (0, None)
                and name not in self._reported and not suppress):
            self._record_error(RuntimeError(
                f"worker {name!r} died with exit code "
                f"{proc.exitcode} ({kind}) without reporting an error"))

    def _monitor(self):
        """Watchdog: surface child errors (and silent deaths) the moment
        they happen."""
        pending = set(self.processes)
        while pending:
            self._drain_errors()
            for name in list(pending):
                proc = self.processes[name]
                if proc.is_alive():
                    continue
                proc.join()
                # give the queue feeder a beat to deliver the child's own
                # error report before synthesizing one from the exit code
                d = time.time() + 1.0
                while (proc.exitcode not in (0, None)
                       and name not in self._reported
                       and time.time() < d):
                    self._drain_errors()
                    time.sleep(0.02)
                self._handle_death(name, proc)
                pending.discard(name)
            time.sleep(0.05)
        self._drain_errors()

    # ---------------------------------------------------------------- stop
    def _initiate_stop(self):
        # order matters: children must see the stop (and its user/fail-fast
        # flavor) before any parent-side table wakes them with a "stopped"
        # rate-limiter error.
        for pipe in list(self._control_pipes.values()):
            try:
                pipe.send(("stop", self._user_stopped))
            except (OSError, ValueError, BrokenPipeError):
                pass    # child already gone
        super()._initiate_stop()

    # ---------------------------------------------------------------- join
    def _join_runners(self, deadline: Optional[float]):
        super()._join_runners(deadline)
        for proc in list(self.processes.values()):
            remaining = (None if deadline is None
                         else max(deadline - time.time(), 0))
            proc.join(remaining)
        if self._monitor_thread is not None:
            alive = any(p.is_alive() for p in list(self.processes.values()))
            if not alive:
                self._monitor_thread.join(timeout=5)
        self._drain_errors()

    def _alive_nodes(self) -> List[str]:
        alive = super()._alive_nodes()
        alive.extend(name for name, p in list(self.processes.items())
                     if p.is_alive())
        return alive

    def _reap_stragglers(self, names: List[str]):
        for name in names:
            proc = self.processes.get(name)
            if proc is not None and proc.is_alive():
                # our own SIGTERM is not a worker death the monitor should
                # re-report
                self._reported.add(name)
                proc.terminate()
                proc.join(timeout=5)


_LAUNCHERS: Dict[str, Type[Launcher]] = {}


def register_launcher(name: str, cls: Type[Launcher]):
    """Register a backend under ``name`` for ``get_launcher`` lookup."""
    if not issubclass(cls, Launcher):
        raise TypeError(f"{cls!r} does not implement the Launcher protocol")
    _LAUNCHERS[name] = cls


def get_launcher(name: str) -> Type[Launcher]:
    """Resolve a backend name (``"local"``, ``"multiprocess"``, or any
    registered extension) to its Launcher class."""
    try:
        return _LAUNCHERS[name]
    except KeyError:
        raise ValueError(
            f"unknown launcher backend {name!r}; registered: "
            f"{sorted(_LAUNCHERS)}") from None


register_launcher("local", LocalLauncher)
register_launcher("multiprocess", MultiprocessLauncher)
