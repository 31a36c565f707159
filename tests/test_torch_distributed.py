"""The port's launcher conformance suite, courier RPC layer and variable
sources: the JAX package's ``tests/test_distributed.py`` cases (launchers,
courier, variable sources) and its courier-retry and supervisor cases of
``tests/test_resilience.py``, on ``repro_torch.distributed``.

The same ``Program`` graph must behave identically on both backends
(``local`` threads, ``multiprocess`` spawned OS processes).  Worker,
service and learner classes are module-level so the multiprocess backend
can pickle them into spawn children, and this module imports no jax: a
child loads torch and the port only.
"""
import os
import pickle
import signal
import socket
import threading
import time

import pytest
import torch

from repro_torch.distributed import (BackoffPolicy, JoinTimeout, Launcher,
                                     LauncherBase, RemoteError, RemoteHandle,
                                     RetryConfig, ServiceUnavailable,
                                     WorkerErrors, courier, get_launcher,
                                     register_launcher, serve,
                                     set_retry_config)
from repro_torch.distributed.courier import Server
from repro_torch.distributed.program import Program, Replica
from repro_torch.learners import (PARAM_SERVER_INTERFACE,
                                  LearnerReplicaWorker, ParameterServer)
from repro_torch.resilience import (CRASH, PREEMPTED, SHUTDOWN,
                                    RestartPolicy, classify_exit)
from torch_threads import one_torch_thread  # noqa: F401

BACKENDS = ["local", "multiprocess"]

# Generous: spawn children pay interpreter and torch startup.
JOIN_S = 60


# --------------------------------------------------------------- node types
class Source:
    def __init__(self, value=41):
        self.value = value

    def get(self):
        return self.value


class Sink:
    """Service the workers report into (the parent cannot reach into a child
    process to read a worker attribute, so conformance tests observe worker
    effects through a service node)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def put(self, value):
        with self._lock:
            self._items.append(value)

    def items(self):
        with self._lock:
            return list(self._items)


class Bridge:
    """Worker: one read from source, one write to sink, exit."""

    def __init__(self, source, sink, offset=1):
        # source/sink may be Handles, courier RemoteHandles, or the objects;
        # this code cannot tell.
        self.source = source
        self.sink = sink
        self.offset = offset

    def run(self):
        self.sink.put(self.source.get() + self.offset)


class Exploder:
    def __init__(self, message="boom"):
        self.message = message

    def run(self):
        raise ValueError(self.message)


class Spinner:
    """Worker: loop until stopped, reporting liveness through the sink."""

    def __init__(self, sink=None):
        self.sink = sink
        self._stop = threading.Event()

    def run(self):
        while not self._stop.is_set():
            if self.sink is not None:
                self.sink.put(1)
            self._stop.wait(0.01)

    def stop(self):
        self._stop.set()


class Stubborn:
    """Worker that ignores stop requests (for join-timeout reporting)."""

    def run(self):
        time.sleep(120)


class TorchThreads:
    """Worker: reports the intra-op thread count torch runs on."""

    def __init__(self, sink):
        self.sink = sink

    def run(self):
        self.sink.put(torch.get_num_threads())


class TickLearner:
    """Minimal learner: state is a float32 0-d tensor; step() bumps it."""

    def __init__(self, value=0.0, step_s=0.0):
        self.state = torch.tensor(value, dtype=torch.float32)
        self.step_s = step_s

    def step(self):
        if self.step_s:
            time.sleep(self.step_s)
        self.state = self.state + torch.tensor(1.0)
        return {}

    def get_variables(self, names=()):
        return [float(self.state)]


class ExplodingLearner(TickLearner):
    def __init__(self, blow_at=3):
        super().__init__()
        self.blow_at = blow_at

    def step(self):
        if float(self.state) >= self.blow_at:
            raise ValueError("replica-boom")
        return super().step()


class SleepyLearner(TickLearner):
    """step() sleeps long enough to straggle past a short join timeout."""

    def __init__(self):
        super().__init__(step_s=8.0)


def _cleanup(launcher):
    """Best-effort teardown for tests that leave stubborn runners behind."""
    launcher.stop()
    for proc in getattr(launcher, "processes", {}).values():
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)


# ------------------------------------------------------- conformance suite
@pytest.mark.parametrize("backend", BACKENDS)
def test_graph_resolution_through_handles(backend):
    prog = Program()
    sink = prog.add_node("sink", Sink, role="service",
                         interface=("put", "items"))
    src = prog.add_node("source", Source, 41, role="service",
                        interface=("get",))
    prog.add_node("bridge", Bridge, src, sink, role="worker")
    launcher = get_launcher(backend)(prog).launch()
    launcher.join(timeout=JOIN_S)
    assert prog.resolve("sink").items() == [42]


@pytest.mark.parametrize("backend", BACKENDS)
def test_replicated_workers(backend):
    """num_replicas expands a worker node into a pool; Replica args give
    each member its own value."""
    prog = Program()
    sink = prog.add_node("sink", Sink, role="service",
                         interface=("put", "items"))
    src = prog.add_node("source", Source, 100, role="service",
                        interface=("get",))
    handles = prog.add_node("bridge", Bridge, src, sink,
                            Replica(lambda i: i), role="worker",
                            num_replicas=3)
    assert [h.node_name for h in handles] == ["bridge/0", "bridge/1",
                                              "bridge/2"]
    launcher = get_launcher(backend)(prog).launch()
    launcher.join(timeout=JOIN_S)
    assert sorted(prog.resolve("sink").items()) == [100, 101, 102]


@pytest.mark.parametrize("backend", BACKENDS)
def test_fail_fast_on_worker_death(backend):
    """The first worker failure stops every sibling; join surfaces it."""
    prog = Program()
    sink = prog.add_node("sink", Sink, role="service",
                         interface=("put", "items"))
    prog.add_node("spinner", Spinner, sink, role="worker")
    prog.add_node("exploder", Exploder, "boom", role="worker")
    launcher = get_launcher(backend)(prog).launch()
    with pytest.raises(Exception) as exc_info:
        launcher.join(timeout=JOIN_S)
    assert "boom" in str(exc_info.value)
    assert launcher.should_stop()
    # spinner observed the fail-fast stop and exited (no timeout needed)
    assert not isinstance(exc_info.value, (JoinTimeout, WorkerErrors)) \
        or all(not isinstance(e, JoinTimeout)
               for e in getattr(exc_info.value, "errors", []))


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_worker_failures_aggregate(backend):
    """Multiple failures arrive as one WorkerErrors — none dropped."""
    prog = Program()
    prog.add_node("a", Exploder, "boom-a", role="worker")
    prog.add_node("b", Exploder, "boom-b", role="worker")
    launcher = get_launcher(backend)(prog).launch()
    with pytest.raises(Exception) as exc_info:
        launcher.join(timeout=JOIN_S)
    err = exc_info.value
    messages = (" ".join(str(e) for e in err.errors)
                if isinstance(err, WorkerErrors) else str(err))
    assert "boom-a" in messages and "boom-b" in messages


@pytest.mark.parametrize("backend", BACKENDS)
def test_stop_join_idempotent(backend):
    prog = Program()
    sink = prog.add_node("sink", Sink, role="service",
                         interface=("put", "items"))
    prog.add_node("spinner", Spinner, sink, role="worker")
    launcher = get_launcher(backend)(prog).launch()
    deadline = time.time() + JOIN_S
    while not prog.resolve("sink").items() and time.time() < deadline:
        time.sleep(0.02)
    assert prog.resolve("sink").items(), "spinner never ran"
    launcher.stop()
    launcher.stop()
    launcher.join(timeout=JOIN_S)
    launcher.join(timeout=JOIN_S)
    assert launcher.should_stop()


@pytest.mark.parametrize("backend", BACKENDS)
def test_join_timeout_names_stragglers(backend):
    prog = Program()
    prog.add_node("stubborn", Stubborn, role="worker")
    launcher = get_launcher(backend)(prog).launch()
    time.sleep(0.3 if backend == "local" else 3.0)   # let the child boot
    launcher.stop()
    with pytest.raises(JoinTimeout) as exc_info:
        launcher.join(timeout=0.5)
    assert "stubborn" in exc_info.value.node_names
    # process backends reap the straggler instead of leaking it
    for proc in getattr(launcher, "processes", {}).values():
        assert not proc.is_alive()
    _cleanup(launcher)


@pytest.mark.parametrize("backend", BACKENDS)
def test_handle_pickling_roundtrip(backend):
    """A handle crossing a process boundary degrades to a courier
    RemoteHandle with identical call syntax — and survives re-pickling."""
    prog = Program()
    handle = prog.add_node("source", Source, 41, role="service",
                           interface=("get",))
    launcher = get_launcher(backend)(prog).launch()
    try:
        launcher.serve("source")   # idempotent (multiprocess already did)
        remote = pickle.loads(pickle.dumps(handle))
        assert isinstance(remote, RemoteHandle)
        assert remote.get() == 41
        # RemoteHandle itself round-trips (its socket never pickles)
        remote2 = pickle.loads(pickle.dumps(remote))
        assert remote2.get() == 41
        # the declared interface survives the boundary
        with pytest.raises(AttributeError):
            remote.value
    finally:
        launcher.stop()
        launcher.join(timeout=JOIN_S)


def test_spawned_children_run_torch_on_the_parents_thread_count():
    """A spawned child would start one torch thread a core; it runs on its
    parent's count instead (here the test's one thread)."""
    prog = Program()
    sink = prog.add_node("sink", Sink, role="service",
                         interface=("put", "items"))
    prog.add_node("threads", TorchThreads, sink, role="worker")
    launcher = get_launcher("multiprocess")(prog).launch()
    launcher.join(timeout=JOIN_S)
    assert prog.resolve("sink").items() == [torch.get_num_threads()] == [1]
    assert launcher.restart_stats() == {
        "restarts": {}, "exit_kinds": {"threads": [SHUTDOWN]},
        "service_restarts": {}, "service_exit_kinds": {}}


def test_multiprocess_launcher_refuses_a_restart_policy():
    """A program with a restart_policy launches (elastic respawn and
    service failover are ported): a worker that runs to its end is not
    respawned, and the launcher's service watchdog starts with the program
    and stops with the join."""
    prog = Program()
    sink = prog.add_node("sink", Sink, role="service",
                         interface=("put", "items"))
    prog.add_node("threads", TorchThreads, sink, role="worker")
    prog.restart_policy = RestartPolicy()
    launcher = get_launcher("multiprocess")(prog).launch()
    assert launcher._watchdog is not None
    launcher.join(timeout=JOIN_S)
    assert prog.resolve("sink").items() == [1]
    assert launcher.restart_stats() == {
        "restarts": {}, "exit_kinds": {"threads": [SHUTDOWN]},
        "service_restarts": {}, "service_exit_kinds": {}}
    assert not launcher._watchdog._thread.is_alive()


def test_silent_child_death_is_classified_and_surfaced():
    """A child killed by a signal reports nothing itself: the monitor
    classifies the exit as a preemption and fails the run."""
    prog = Program()
    prog.add_node("stubborn", Stubborn, role="worker")
    launcher = get_launcher("multiprocess")(prog).launch()
    proc = launcher.processes["stubborn"]
    deadline = time.time() + JOIN_S
    while proc.pid is None and time.time() < deadline:
        time.sleep(0.02)
    os.kill(proc.pid, signal.SIGKILL)
    with pytest.raises(RuntimeError, match="preempted"):
        launcher.join(timeout=JOIN_S)
    assert launcher.restart_stats()["exit_kinds"] == {
        "stubborn": [PREEMPTED]}


# ----------------------------------------- learner-replica node conformance
def _replica_program(learners, average_period=2, max_steps=6):
    """The multi-learner node shape ``make_distributed_agent`` emits:
    ``learner/replica_i`` run+serve hybrids around a shared
    ``learner/param_server`` rendezvous."""
    prog = Program()
    server = ParameterServer(len(learners), average_period)
    prog.add_node("learner/param_server", lambda: server, role="service",
                  interface=PARAM_SERVER_INTERFACE)
    handles = []
    for i, learner in enumerate(learners):
        worker = LearnerReplicaWorker(learner, server, i, average_period,
                                      max_steps=max_steps)
        handles.append(prog.add_node(f"learner/replica_{i}",
                                     lambda w=worker: w, role="service",
                                     interface=("get_variables",)))
    return prog, server, handles


@pytest.mark.parametrize("backend", BACKENDS)
def test_learner_replica_nodes_step_and_average(backend):
    """Replica nodes run as run+serve hybrids on every backend: both step
    to max_steps, rendezvous at the param server, and serve exactly their
    declared interface."""
    prog, server, handles = _replica_program(
        [TickLearner(0.0), TickLearner(4.0)], average_period=2, max_steps=6)
    launcher = get_launcher(backend)(prog).launch()
    try:
        launcher.join(timeout=JOIN_S)
    finally:
        launcher.stop()
    assert server.rounds == 3          # 6 steps / period 2
    # averaging pulled the two streams together: both replicas converged to
    # the shared mean trajectory
    v0 = prog.resolve("learner/replica_0").get_variables()[0]
    v1 = prog.resolve("learner/replica_1").get_variables()[0]
    assert v0 == v1 == 8.0
    # interface enforcement on the replica handle
    assert handles[0].get_variables() == [v0]
    with pytest.raises(AttributeError):
        handles[0].learner
    with pytest.raises(AttributeError):
        handles[0].run


@pytest.mark.parametrize("backend", BACKENDS)
def test_learner_replica_death_fails_fast(backend):
    """One replica dying stops its siblings (the survivor is released from
    the averaging barrier instead of waiting forever) and join surfaces
    the error."""
    prog, server, _ = _replica_program(
        [ExplodingLearner(blow_at=3), TickLearner(0.0)],
        average_period=2, max_steps=100)
    launcher = get_launcher(backend)(prog).launch()
    with pytest.raises(Exception) as exc_info:
        launcher.join(timeout=JOIN_S)
    assert "replica-boom" in str(exc_info.value)
    assert launcher.should_stop()
    assert server.stopped


@pytest.mark.parametrize("backend", BACKENDS)
def test_join_timeout_names_straggler_replica(backend):
    """A replica stuck inside a long learner step is named by JoinTimeout."""
    prog, _, _ = _replica_program([SleepyLearner()], average_period=100,
                                  max_steps=1)
    launcher = get_launcher(backend)(prog).launch()
    time.sleep(0.3)                     # let the replica enter its step
    launcher.stop()
    with pytest.raises(JoinTimeout) as exc_info:
        launcher.join(timeout=0.5)
    assert "learner/replica_0" in exc_info.value.node_names
    _cleanup(launcher)


def test_unserved_handle_refuses_to_pickle():
    prog = Program()
    handle = prog.add_node("source", Source, role="service")
    with pytest.raises(pickle.PicklingError):
        pickle.dumps(handle)


# ------------------------------------------------------------ program graph
def test_duplicate_node_rejected():
    prog = Program()
    prog.add_node("a", Source)
    with pytest.raises(ValueError):
        prog.add_node("a", Source)


def test_bad_role_rejected():
    prog = Program()
    with pytest.raises(ValueError):
        prog.add_node("a", Source, role="supervisor")
    with pytest.raises(ValueError):
        prog.add_node("b", Source, role="worker", is_worker=True)


def test_is_worker_compat_spelling():
    prog = Program()
    prog.add_node("w", Spinner, is_worker=True)
    assert prog.node("w").role == "worker"
    assert prog.node("w").is_worker


def test_handle_dereference_is_lazy_and_cached():
    prog = Program()
    calls = []

    def factory():
        calls.append(1)
        return Source(1)

    h = prog.add_node("s", factory)
    assert not calls
    assert h.get() == 1
    assert h.get() == 1
    assert len(calls) == 1


def test_handle_enforces_declared_interface():
    prog = Program()
    h = prog.add_node("s", Source, role="service", interface=("get",))
    assert h.get() == 41
    with pytest.raises(AttributeError):
        h.value


def test_launcher_registry():
    assert get_launcher("local").backend == "local"
    assert get_launcher("multiprocess").backend == "multiprocess"
    with pytest.raises(ValueError, match="unknown launcher"):
        get_launcher("fleet-of-zeppelins")

    class DummyLauncher(LauncherBase):
        backend = "dummy-test"

        def launch(self):
            return self

    register_launcher("dummy-test", DummyLauncher)
    try:
        assert get_launcher("dummy-test") is DummyLauncher
        assert issubclass(DummyLauncher, Launcher)
    finally:
        from repro_torch.distributed import launchers as launchers_lib
        launchers_lib._LAUNCHERS.pop("dummy-test", None)


# ----------------------------------------------------------------- courier
def test_courier_call_args_kwargs():
    class Calc:
        def mul(self, a, b=2):
            return a * b

    server, handle = serve(Calc(), name="calc")
    try:
        assert handle.mul(3) == 6
        assert handle.mul(3, b=5) == 15
        assert handle.call("mul", 4, b=4) == 16
    finally:
        server.stop()


def test_courier_preserves_exception_type():
    class Flaky:
        def blow(self):
            raise KeyError("missing-thing")

    server, handle = serve(Flaky(), name="flaky")
    try:
        with pytest.raises(KeyError, match="missing-thing"):
            handle.blow()
        # the connection survives a remote exception
        with pytest.raises(KeyError):
            handle.blow()
    finally:
        server.stop()


def test_courier_unpicklable_exception_becomes_remote_error():
    class Cursed(RuntimeError):
        def __init__(self):
            super().__init__("cursed")
            self.lock = threading.Lock()    # unpicklable payload

    class Target:
        def blow(self):
            raise Cursed()

    server, handle = serve(Target(), name="cursed")
    try:
        with pytest.raises(RemoteError, match="Cursed"):
            handle.blow()
    finally:
        server.stop()


def test_courier_server_enforces_interface():
    server, _ = serve(Source(7), interface=("get",), name="src")
    try:
        # bypass the client-side allowlist: the server still refuses
        sneaky = RemoteHandle(server.address, name="src", interface=None,
                              authkey=server.authkey)
        assert sneaky.get() == 7
        with pytest.raises(AttributeError, match="interface"):
            sneaky.call("value")
    finally:
        server.stop()


def test_courier_rejects_unauthenticated_connections():
    """The unpickling server must not accept frames from arbitrary local
    processes: connections without the authkey are refused before any
    payload is read."""
    server, handle = serve(Source(7), interface=("get",), name="src")
    try:
        intruder = RemoteHandle(server.address, name="src",
                                interface=("get",), authkey=b"wrong-key")
        with pytest.raises(ConnectionError, match="authentication"):
            intruder.get()
        keyless = RemoteHandle(server.address, name="src",
                               interface=("get",))
        with pytest.raises(ConnectionError, match="authentication"):
            keyless.get()
        assert handle.get() == 7      # the real client still works
    finally:
        server.stop()


class _TwoArgError(Exception):
    """Pickles via dumps but fails to REconstruct on loads (multi-arg
    __init__ with single-arg args tuple)."""

    def __init__(self, limit, used):
        super().__init__(f"quota {used}/{limit}")
        self.limit, self.used = limit, used


def test_courier_unreconstructable_exception_becomes_remote_error():
    class Target:
        def blow(self):
            raise _TwoArgError(10, 11)

    server, handle = serve(Target(), name="quota")
    try:
        with pytest.raises(RemoteError, match="_TwoArgError"):
            handle.blow()
    finally:
        server.stop()


def test_courier_unpicklable_response_becomes_remote_error():
    """A result that fails to pickle must answer as an error frame, not
    silently kill the connection."""
    class Target:
        def get_lock(self):
            return threading.Lock()

        def get_value(self):
            return 7

    server, handle = serve(Target(), name="locky")
    try:
        with pytest.raises(RemoteError, match="could not be pickled"):
            handle.get_lock()
        assert handle.get_value() == 7    # the connection survives
    finally:
        server.stop()


def test_courier_rate_limiter_timeout_crosses_the_wire():
    """Shutdown-noise classification depends on remote errors keeping their
    type: a RateLimiterTimeout raised server-side must re-raise as itself."""
    from repro_torch.replay.rate_limiter import RateLimiterTimeout

    class Table:
        def insert(self):
            raise RateLimiterTimeout("stopped")

    server, handle = serve(Table(), name="table")
    try:
        with pytest.raises(RateLimiterTimeout):
            handle.insert()
    finally:
        server.stop()


# ------------------------------------------------- courier retry, backoff
def test_backoff_policy_deterministic_when_unjittered():
    policy = BackoffPolicy(base_s=0.1, factor=2.0, max_s=0.5, jitter=0.0)
    assert [policy.delay(a) for a in range(4)] == [0.1, 0.2, 0.4, 0.5]


def test_backoff_policy_jitter_stays_in_band():
    import random
    policy = BackoffPolicy(base_s=0.1, factor=2.0, max_s=1.0, jitter=0.5)
    rng = random.Random(0)
    for attempt in range(5):
        full = min(0.1 * 2.0 ** attempt, 1.0)
        for _ in range(20):
            d = policy.delay(attempt, rng=rng)
            assert full * 0.5 <= d <= full


def test_backoff_policy_validation():
    with pytest.raises(ValueError):
        BackoffPolicy(base_s=-1.0)
    with pytest.raises(ValueError):
        BackoffPolicy(factor=0.5)
    with pytest.raises(ValueError):
        BackoffPolicy(jitter=1.5)


def test_retry_config_validation_and_install():
    with pytest.raises(ValueError):
        RetryConfig(max_attempts=0)
    with pytest.raises(ValueError):
        RetryConfig(reconnect_deadline_s=0.0)
    with pytest.raises(TypeError):
        RetryConfig(backoff="fast")

    custom = RetryConfig(max_attempts=5, reconnect_deadline_s=9.0,
                         backoff=BackoffPolicy(base_s=0.01))
    try:
        set_retry_config(custom)
        assert courier.retry_config() is custom
        with pytest.raises(TypeError):
            set_retry_config("nope")
    finally:
        set_retry_config(None)
    assert courier.retry_config().max_attempts == 3   # defaults restored


class _Values:
    def __init__(self):
        self.values = []

    def size(self):            # idempotent (IDEMPOTENT_METHODS)
        return len(self.values)

    def put(self, v):          # non-idempotent
        self.values.append(v)
        return v


def test_remote_handle_raises_service_unavailable_after_deadline():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()    # nobody listens here now
    handle = RemoteHandle(("127.0.0.1", port), name="gone",
                          interface=("size",))
    set_retry_config(RetryConfig(
        reconnect_deadline_s=0.3,
        backoff=BackoffPolicy(base_s=0.02, max_s=0.05)))
    try:
        t0 = time.monotonic()
        with pytest.raises(ServiceUnavailable, match="unreachable"):
            handle.size()
        elapsed = time.monotonic() - t0
        assert 0.25 <= elapsed < 5.0, elapsed
    finally:
        set_retry_config(None)
    # ServiceUnavailable IS a ConnectionError: workers catch one type
    assert issubclass(ServiceUnavailable, ConnectionError)


def test_remote_handle_reconnects_through_restart_window():
    """A server stop + same-address re-bind mid-call must be invisible to
    the client — for an idempotent AND a non-idempotent method (the frame
    died before a single response byte, so the handler never ran)."""
    target = _Values()
    server, handle = serve(target, interface=("size", "put"), name="stats")
    assert handle.put("a") == "a"     # cache a live connection
    address, authkey = server.address, server.authkey
    server.stop()

    replacement = {}

    def rebind():
        time.sleep(0.3)
        replacement["server"] = Server(
            target, interface=("size", "put"), name="stats",
            host=address[0], port=address[1], authkey=authkey).start()

    threading.Thread(target=rebind, daemon=True).start()
    set_retry_config(RetryConfig(
        reconnect_deadline_s=10.0,
        backoff=BackoffPolicy(base_s=0.02, max_s=0.1)))
    try:
        assert handle.put("b") == "b"        # non-idempotent, stale socket
        assert handle.size() == 2            # idempotent, fresh socket
        assert target.values == ["a", "b"]   # executed exactly once
    finally:
        set_retry_config(None)
        replacement["server"].stop()


def test_auth_failure_fast_fails_without_reconnect_retries():
    server, _ = serve(_Values(), interface=("size", "put"), name="stats")
    bad = RemoteHandle(server.address, name="stats", interface=("size",),
                       authkey=b"wrong")
    try:
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="authentication"):
            bad.size()
        # a wrong key is not transient: no 5s reconnect window burned
        assert time.monotonic() - t0 < 2.0
    finally:
        server.stop()


# ------------------------------------------------------------- supervisor
def test_classify_exit():
    assert classify_exit(0) == SHUTDOWN
    assert classify_exit(1) == CRASH
    assert classify_exit(42) == CRASH
    assert classify_exit(-signal.SIGKILL) == PREEMPTED
    assert classify_exit(-signal.SIGTERM) == PREEMPTED
    # a death observed during an orderly stop is never an incident
    assert classify_exit(1, stopping=True) == SHUTDOWN


def test_restart_policy_backoff_and_budget():
    policy = RestartPolicy(max_restarts=3, backoff_base_s=0.1,
                           backoff_factor=2.0, backoff_max_s=0.5)
    assert [policy.backoff(i) for i in range(4)] == [0.1, 0.2, 0.4, 0.5]
    assert policy.should_restart(CRASH, 2)
    assert not policy.should_restart(CRASH, 3)       # budget exhausted
    assert not policy.should_restart(SHUTDOWN, 0)    # clean exits stay down
    crash_only = RestartPolicy(restart_on=(CRASH,))
    assert not crash_only.should_restart(PREEMPTED, 0)


def test_restart_policy_validation():
    with pytest.raises(ValueError):
        RestartPolicy(max_restarts=-1)
    with pytest.raises(ValueError):
        RestartPolicy(backoff_factor=0.5)
    with pytest.raises(ValueError):
        RestartPolicy(restart_on=("sigsegv",))


# ------------------------------------------------------- variable sources
def test_variable_server_empty_names_returns_all():
    from repro_torch.core import VariableServer
    server = VariableServer(policy=[1, 2], critic=[3])
    assert server.get_variables(()) == [[1, 2], [3]]
    assert server.get_variables() == [[1, 2], [3]]
    assert server.get_variables(("critic",)) == [[3]]


def test_variable_source_served_over_courier():
    from repro_torch.core import VariableClient, VariableServer
    from repro_torch.core.variable import serve_variable_source
    vs = VariableServer(policy=[1, 2, 3])
    server, handle = serve_variable_source(vs)
    try:
        client = VariableClient(handle)
        assert client.params == [1, 2, 3]
        vs.publish("policy", [4])
        client.update(wait=True)
        assert client.params == [4]
        # empty names over RPC: all published variables
        assert handle.get_variables(()) == [[4]]
        with pytest.raises(AttributeError):
            handle.publish("policy", [5])   # not in the served interface
    finally:
        server.stop()


class _CountingSource:
    def __init__(self):
        self.fetches = 0

    def get_variables(self, names=()):
        self.fetches += 1
        return [[self.fetches]]


def test_variable_client_no_initial_double_fetch():
    """params populated by the property accessor must not be re-fetched by
    the immediately following update(wait=False)."""
    from repro_torch.core import VariableClient
    source = _CountingSource()
    client = VariableClient(source, update_period=1)
    assert client.params == [1]
    assert source.fetches == 1
    client.update(wait=False)          # just fetched: deduped
    assert source.fetches == 1
    client.update(wait=False)          # cadence resumes (period=1)
    assert source.fetches == 2


def test_variable_client_period_still_honoured():
    from repro_torch.core import VariableClient
    source = _CountingSource()
    client = VariableClient(source, update_period=5)
    for _ in range(10):
        client.update()
    # fetch on first call (no params yet) + every 5th call
    assert source.fetches == 3
    client.update(wait=True)
    assert source.fetches == 4


def test_learner_variables_cross_courier_as_numpy():
    """A port learner's ``get_variables`` over courier: numpy on the wire,
    never a tensor (a tensor on the card in a pickle would start a CUDA
    context in every actor process)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.agents.dqn import DQNBuilder, DQNConfig
    from repro_torch.core import make_environment_spec
    from repro_torch.core.variable import serve_variable_source
    from repro_torch.envs import Catch

    builder = DQNBuilder(make_environment_spec(Catch(seed=0)),
                         DQNConfig(batch_size=4), device="cpu")
    learner = builder.make_learner(iter(()))
    server, handle = serve_variable_source(learner)
    try:
        (params,) = handle.get_variables(("policy",))
    finally:
        server.stop()
    leaves = tree.leaves(params)
    assert leaves and all(isinstance(x, np.ndarray) for x in leaves)
    for x, y in zip(leaves, tree.leaves(learner.state.params)):
        np.testing.assert_array_equal(x, y.numpy())
