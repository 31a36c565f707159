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
import sys
import threading
import time
from typing import Dict, List, Optional, Type

from repro_torch.distributed.courier import RemoteHandle, Server, picklable_error
from repro_torch.distributed.program import Node, Program
from repro_torch.resilience.chaos import RESTARTS_ENV
from repro_torch.resilience.supervisor import classify_exit
from repro_torch.telemetry import registry as _telemetry


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


def _child_main(node_name, payload, control_pipe, error_queue, restarts,
                torch_threads):
    """Entry point of a spawned worker process: rebuild the node from its
    pickled (factory, args, kwargs) — Handles arrive as RemoteHandles — and
    drive its run loop until done or stopped.

    ``restarts`` counts how many times this worker has been respawned by
    the elastic supervisor; it is published via ``RESTARTS_ENV`` before the
    node is built so chaos kill schedules can disarm after ``max_kills``.
    The child runs torch on ``torch_threads`` intra-op threads, its
    parent's count: a fresh interpreter would otherwise start one a core,
    and a fleet of children on one host would oversubscribe it.
    """
    import faulthandler
    import os
    import signal
    import sys

    import torch
    # SIGUSR1 dumps every thread's stack to stderr — the only way to see
    # where a live worker is stuck from outside (hangs, chaos debugging).
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    os.environ[RESTARTS_ENV] = str(restarts)
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
    ``classify_exit``, and under the program's ``restart_policy`` a dead
    worker respawns (a fresh spawn child, so it never inherits a CUDA
    context) and killed services are restored by a ``ServiceWatchdog``.
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
        self._monitor_thread: Optional[threading.Thread] = None
        # --- elastic supervision (repro_torch.resilience) -------------------
        # When the program carries a RestartPolicy, dead workers are
        # respawned from their stored spawn payloads instead of failing
        # the run: deaths are classified (crash/preempted/shutdown),
        # restarts are budgeted per worker with exponential backoff.
        self._policy = getattr(program, "restart_policy", None)
        self._payloads: Dict[str, bytes] = {}
        self._restarts: Dict[str, int] = {}
        self._exit_kinds: Dict[str, List[str]] = {}
        self._respawn_at: Dict[str, float] = {}
        self._stashed: Dict[str, BaseException] = {}
        self._m_restarts = None
        # Parent-side failover for role="service" nodes (periodic snapshot,
        # kill classification, budgeted restore + courier re-bind); started
        # by launch() when the program carries a RestartPolicy.
        self._watchdog = None
        # Spawns and the stop's relay to the children take turns: a child
        # spawned after the relay went out would never hear of the stop
        # and would run on until join() reaps it as a straggler.
        self._spawn_lock = threading.Lock()
        self._stop_relayed = False

    def restart_stats(self) -> Dict:
        """Supervisor bookkeeping: per-worker restart counts and the
        classification of every death observed, plus the service watchdog's
        own restore accounting."""
        stats = {"restarts": dict(self._restarts),
                 "exit_kinds": {k: list(v)
                                for k, v in self._exit_kinds.items()}}
        if self._watchdog is not None:
            stats.update(self._watchdog.stats())
        else:
            stats["service_restarts"] = {}
            stats["service_exit_kinds"] = {}
        return stats

    def launch(self) -> "MultiprocessLauncher":
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
            # 2b. with a RestartPolicy, services get failover too: the
            # watchdog snapshots every recoverable service and restores
            # killed ones at the same courier address.
            if self._policy is not None:
                from repro_torch.resilience.failover import ServiceWatchdog
                self._watchdog = ServiceWatchdog(
                    self, self._policy,
                    chaos=getattr(self.program, "chaos_policy", None),
                    snapshot_period_s=getattr(
                        self.program, "service_snapshot_period_s", 0.5))
                for node in self.program.nodes:
                    if node.role == "service":
                        self._watchdog.register(node.name, node.instance)
                self._watchdog.start()
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
                self._payloads[node.name] = payload
                self._spawn(node.name, restarts=0)
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

    def _spawn(self, name: str, restarts: int) -> bool:
        """Start (or restart) worker ``name`` from its stored payload, on
        its parent's torch thread count; False, and nothing started, once
        the stop has been relayed to the children."""
        import torch
        with self._spawn_lock:
            if self._stop_relayed:
                return False
            parent_end, child_end = self._ctx.Pipe()
            old_pipe = self._control_pipes.get(name)
            self._control_pipes[name] = parent_end
            if old_pipe is not None:
                try:
                    old_pipe.close()
                except OSError:
                    pass
            proc = self._ctx.Process(
                target=_child_main,
                args=(name, self._payloads[name], child_end,
                      self._error_queue, restarts, torch.get_num_threads()),
                name=name, daemon=True)
            self.processes[name] = proc
            proc.start()
            child_end.close()   # parent keeps only its own end
        return True

    def _abort_launch(self):
        self.stop()
        for proc in list(self.processes.values()):
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
        self._close_servers()

    # ------------------------------------------------------------- monitor
    def _may_restart(self, name: str) -> bool:
        """Whether worker ``name`` is still inside its restart budget (the
        exit-kind half of the decision waits for the exit code)."""
        return (self._policy is not None
                and not self._stop.is_set()
                and name in self._payloads
                and self._restarts.get(name, 0) < self._policy.max_restarts)

    def _drain_errors(self):
        import queue as queue_lib
        while True:
            try:
                name, exc = self._error_queue.get_nowait()
            except (queue_lib.Empty, OSError, EOFError):
                return
            if self._may_restart(name):
                # A restart-eligible worker's error is held back until its
                # death is classified: a restarted crash is logged, not
                # fatal.  If the supervisor declines the restart the error
                # surfaces through the normal fail-fast path below.
                self._stashed[name] = exc
            else:
                self._reported.add(name)
                self._record_error(exc)

    def _restart_metric(self):
        if self._m_restarts is None:
            if not _telemetry.enabled():
                return None
            self._m_restarts = _telemetry.counter("resilience/restarts")
        return self._m_restarts

    def _handle_death(self, name: str, proc) -> bool:
        """Classify a dead worker and either schedule its respawn (True:
        keep it pending) or surface the failure fail-fast (False)."""
        kind = classify_exit(proc.exitcode, stopping=self._stop.is_set())
        self._exit_kinds.setdefault(name, []).append(kind)
        count = self._restarts.get(name, 0)
        if (self._policy is not None and name in self._payloads
                and not self._stop.is_set()
                and self._policy.should_restart(kind, count)):
            delay = self._policy.backoff(count)
            self._restarts[name] = count + 1
            stashed = self._stashed.pop(name, None)
            detail = f": {type(stashed).__name__}: {stashed}" if stashed \
                else ""
            print(f"[launcher] worker {name!r} {kind} (exit "
                  f"{proc.exitcode}){detail} — restart "
                  f"{count + 1}/{self._policy.max_restarts} in "
                  f"{delay:.2f}s", file=sys.stderr, flush=True)
            metric = self._restart_metric()
            if metric:
                metric.inc()
                _telemetry.counter(f"resilience/restarts/{name}").inc()
            self._respawn_at[name] = time.time() + delay
            return True
        stashed = self._stashed.pop(name, None)
        suppress = self._stop.is_set() and self._user_stopped
        if stashed is not None:
            self._reported.add(name)
            if not suppress:
                self._record_error(stashed)
        elif (proc.exitcode not in (0, None)
                and name not in self._reported and not suppress):
            self._record_error(RuntimeError(
                f"worker {name!r} died with exit code "
                f"{proc.exitcode} ({kind}) without reporting an error"))
        return False

    def _monitor(self):
        """Watchdog: surface child errors (and silent deaths) the moment
        they happen — fail-fast by default, elastic respawn for workers
        covered by the program's ``RestartPolicy``."""
        pending = set(self.processes)
        while pending:
            self._drain_errors()
            now = time.time()
            for name, due in list(self._respawn_at.items()):
                if self._stop.is_set():
                    self._respawn_at.pop(name, None)
                    pending.discard(name)
                elif now >= due:
                    self._respawn_at.pop(name, None)
                    self._reported.discard(name)
                    if not self._spawn(name, restarts=self._restarts[name]):
                        pending.discard(name)   # the stop came first
            for name in list(pending):
                if name in self._respawn_at:
                    continue
                proc = self.processes[name]
                if proc.is_alive():
                    continue
                proc.join()
                # give the queue feeder a beat to deliver the child's own
                # error report before synthesizing one from the exit code
                d = time.time() + 1.0
                while (proc.exitcode not in (0, None)
                       and name not in self._reported
                       and name not in self._stashed
                       and time.time() < d):
                    self._drain_errors()
                    time.sleep(0.02)
                if not self._handle_death(name, proc):
                    pending.discard(name)
            time.sleep(0.05)
        self._drain_errors()

    # ---------------------------------------------------------------- stop
    def _initiate_stop(self):
        # the watchdog must not restore services into a run that is tearing
        # down (request only — joining here could self-deadlock when the
        # stop originates from the watchdog's own error path)
        if self._watchdog is not None:
            self._watchdog.request_stop()
        # order matters: children must see the stop (and its user/fail-fast
        # flavor) before any parent-side table wakes them with a "stopped"
        # rate-limiter error.  Under the spawn lock, so that no respawn
        # slips in after the relay.
        with self._spawn_lock:
            self._stop_relayed = True
            pipes = list(self._control_pipes.values())
        for pipe in pipes:
            try:
                pipe.send(("stop", self._user_stopped))
            except (OSError, ValueError, BrokenPipeError):
                pass    # child already gone
        super()._initiate_stop()

    # ---------------------------------------------------------------- join
    def _join_runners(self, deadline: Optional[float]):
        super()._join_runners(deadline)
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)

        def remaining():
            return (None if deadline is None
                    else max(deadline - time.time(), 0))
        # The monitor ends once every worker is down for good, so it is
        # joined first: a worker respawned meanwhile replaces its entry in
        # ``processes``, and a join of the entries read before would miss
        # the new child.
        if self._monitor_thread is not None:
            self._monitor_thread.join(remaining())
        for proc in list(self.processes.values()):
            proc.join(remaining())
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
