"""The port's fault tolerance on the CPU: elastic worker respawn, chaos
injection, service failover (``ServiceWatchdog``) and the snapshots it
takes (``HostTree``) — the cases of the reference's
``tests/test_resilience.py`` that no other port test covers, and the
port's own cases where the card changes what a snapshot must do.

- chaos: schedules, validation, disarm after ``max_kills``, the RPC fault
  injector and courier calls retried through injected drops;
- elastic supervision: the multiprocess launcher respawns a crashed or a
  preempted worker (on its parent's torch thread count, with its restart
  count published), fails fast once the budget is spent or with no policy,
  and spawns nothing once a stop has been relayed;
- service failover: simulated death of a table, the counter, a shard, a
  learner replica and the async parameter service; restore from a
  snapshot at the same courier address; the restart budget; a replica
  restored leaf for leaf while its run loop is live;
- ``HostTree``: one host copy a device, leaves back in their dtype, shape
  and device, picklable as bytes;
- the port's learners replace their state each step and never write a
  leaf in place, which is what makes a snapshot taken beside a running
  learner a consistent state.

Worker and service classes are module-level and this module imports no
jax, so spawned (and respawned) children load torch and the port only.
"""
import dataclasses
import os
import pickle
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.agents.dqn import DQNBuilder, DQNConfig
from repro_torch.core import make_environment_spec, types
from repro_torch.core.loop import Counter
from repro_torch.distributed import ServiceUnavailable, courier
from repro_torch.distributed.launchers import MultiprocessLauncher
from repro_torch.distributed.program import Program
from repro_torch.envs import Catch
from repro_torch.experiments import run_experiment
from repro_torch.learners import (ASYNC_PARAM_SERVICE_INTERFACE,
                                  AsyncParameterService,
                                  LearnerReplicaWorker, ParameterServer)
from repro_torch.replay import (MinSize, Prioritized, Table, Uniform,
                                make_replay_shards)
from repro_torch.replay.dataset import ReplaySample, SampleInfo
from repro_torch.resilience import (CRASH, PREEMPTED, ChaosPolicy, HostTree,
                                    KillSchedule, RestartPolicy,
                                    RPCChaosInjector, ServiceWatchdog,
                                    is_recoverable, service_activity)
from repro_torch.resilience.chaos import RESTARTS_ENV, worker_restarts
from torch_factories import (make_dqn_catch_config,
                             make_transformer_catch_config)
from torch_threads import one_torch_thread  # noqa: F401

JOIN_S = 60
SMALL = dict(min_replay_size=8, samples_per_insert=0.0, batch_size=8,
             n_step=1, prioritized=False)


def _wait_for(predicate, timeout=JOIN_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return False


# ======================================================== chaos schedules
def test_chaos_policy_schedules_targets_only():
    policy = ChaosPolicy(kill_after_steps=10, kill_targets=("actor/0",),
                         kill_jitter_steps=5, seed=3)
    sched = policy.schedule_for("actor/0")
    assert sched is not None
    assert 10 <= sched.kill_step <= 15
    assert policy.schedule_for("actor/0").kill_step == sched.kill_step
    assert policy.schedule_for("actor/1") is None
    assert ChaosPolicy().schedule_for("actor/0") is None


def test_chaos_policy_validation():
    with pytest.raises(ValueError):
        ChaosPolicy(kill_after_steps=0)
    with pytest.raises(ValueError):
        ChaosPolicy(rpc_drop_rate=1.0)
    with pytest.raises(ValueError):
        ChaosPolicy(rpc_delay_ms=-1.0)
    with pytest.raises(ValueError):
        ChaosPolicy(kill_exit_code=0)
    with pytest.raises(ValueError):
        KillSchedule("actor/0", kill_step=0, exit_code=42, max_kills=1)


def test_kill_schedule_disarms_after_max_kills(monkeypatch):
    class _Actor:
        def observe(self):
            return "ok"

    sched = KillSchedule("actor/0", kill_step=100, exit_code=42, max_kills=1)
    monkeypatch.setenv(RESTARTS_ENV, "0")
    assert sched.armed and worker_restarts() == 0
    wrapped = KillSchedule("actor/0", 100, 42, 1).wrap(_Actor())
    assert wrapped.observe() == "ok"      # counts but far from kill_step
    monkeypatch.setenv(RESTARTS_ENV, "1")
    assert not sched.armed
    bare = _Actor()
    assert KillSchedule("actor/0", 100, 42, 1).wrap(bare) is bare
    monkeypatch.setenv(RESTARTS_ENV, "garbage")
    assert worker_restarts() == 0


def test_rpc_injector_counts_faults():
    inj = RPCChaosInjector(drop_rate=0.9, seed=0)
    drops = 0
    for _ in range(30):
        try:
            inj.before_send()
        except ConnectionError:
            drops += 1
    assert drops == inj.injected["drops"] > 20
    delayed = RPCChaosInjector(delay_ms=20.0)
    t0 = time.monotonic()
    delayed.before_send()
    assert time.monotonic() - t0 >= 0.019
    assert delayed.injected == {"delays": 1, "drops": 0}
    assert ChaosPolicy().rpc_injector() is None


class _Stats:
    def __init__(self):
        self.values = []

    def size(self):
        return 123

    def put(self, v):            # non-idempotent
        self.values.append(v)
        return v


def test_courier_retries_through_injected_drops():
    """Idempotent and non-idempotent calls ride through injected drops
    (a drop fires before any byte is sent, so retrying never runs a call
    twice): every call succeeds and ``put`` runs exactly once each."""
    target = _Stats()
    server, handle = courier.serve(target, interface=("size", "put"),
                                   name="stats")
    inj = RPCChaosInjector(drop_rate=0.3, seed=0)
    inj.install()
    try:
        for i in range(40):
            assert handle.size() == 123
            assert handle.put(i) == i
        assert inj.injected["drops"] >= 5
        assert target.values == list(range(40))
    finally:
        courier.set_rpc_chaos(None)
        server.stop()


# ==================================================== elastic supervision
class _Reports:
    """Service the workers report lives into."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def put(self, value):
        with self._lock:
            self._items.append(value)

    def items(self):
        with self._lock:
            return list(self._items)


class _CrashOnce:
    """Worker: first life crashes hard; the respawn reports and exits."""

    def __init__(self, reports, exit_code=42):
        self.reports = reports
        self.exit_code = exit_code
        self.restarts = worker_restarts()

    def run(self):
        if self.restarts == 0:
            os._exit(self.exit_code)
        self.reports.put(f"alive after {self.restarts} restart")

    def stop(self):
        pass


class _PreemptOnce(_CrashOnce):
    """First life dies by signal (preemption); the respawn reports."""

    def run(self):
        if self.restarts == 0:
            os.kill(os.getpid(), signal.SIGKILL)
        self.reports.put("survived preemption")


class _ThreadsAfterRespawn(_CrashOnce):
    """First life crashes; the respawn reports its restart count, torch's
    thread count and whether it loaded jax or the reference package."""

    def run(self):
        if self.restarts == 0:
            os._exit(self.exit_code)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        self.reports.put((self.restarts, torch.get_num_threads(), loaded,
                          torch.cuda.is_initialized()))


class _AlwaysCrash:
    def run(self):
        os._exit(7)

    def stop(self):
        pass


class _SlowCrash:
    """Crashes a moment after starting, so a respawn is due a while later."""

    def run(self):
        time.sleep(0.3)
        os._exit(9)

    def stop(self):
        pass


def _elastic_program(worker_cls, policy, **worker_kwargs):
    program = Program("elastic")
    program.restart_policy = policy
    reports = program.add_node("reports", _Reports, role="service",
                               interface=("put", "items"))
    program.add_node("worker", worker_cls, reports, role="worker",
                     **worker_kwargs)
    return program, MultiprocessLauncher(program)


def test_supervisor_respawns_crashed_worker():
    program, launcher = _elastic_program(_CrashOnce,
                                         RestartPolicy(max_restarts=2))
    launcher.launch()
    try:
        assert _wait_for(lambda: program.resolve("reports").items()), \
            f"respawned worker never reported; {launcher.restart_stats()}"
    finally:
        launcher.stop()
        launcher.join(timeout=JOIN_S)
    stats = launcher.restart_stats()
    assert stats["restarts"] == {"worker": 1}
    assert stats["exit_kinds"]["worker"][0] == CRASH
    assert program.resolve("reports").items() == ["alive after 1 restart"]


def test_supervisor_respawns_preempted_worker():
    program, launcher = _elastic_program(_PreemptOnce,
                                         RestartPolicy(max_restarts=2))
    launcher.launch()
    try:
        assert _wait_for(lambda: program.resolve("reports").items())
    finally:
        launcher.stop()
        launcher.join(timeout=JOIN_S)
    stats = launcher.restart_stats()
    assert stats["exit_kinds"]["worker"][0] == PREEMPTED
    assert program.resolve("reports").items() == ["survived preemption"]


def test_respawned_worker_is_a_fresh_spawn_child():
    """A respawn is a new spawn child: it sees its restart count, runs
    torch on its parent's thread count (here the test's one), loads neither
    jax nor the reference package, and has no CUDA context."""
    program, launcher = _elastic_program(_ThreadsAfterRespawn,
                                         RestartPolicy(max_restarts=1))
    launcher.launch()
    launcher.join(timeout=JOIN_S)
    assert program.resolve("reports").items() == [(1, 1, [], False)]
    assert launcher.restart_stats()["restarts"] == {"worker": 1}


def test_supervisor_fails_fast_when_budget_exhausted():
    program = Program("exhausted")
    program.restart_policy = RestartPolicy(max_restarts=1,
                                           backoff_base_s=0.05)
    program.add_node("worker", _AlwaysCrash, role="worker")
    launcher = MultiprocessLauncher(program).launch()
    with pytest.raises(Exception, match="crash"):
        launcher.join(timeout=JOIN_S)
    # one respawn granted, the second death exhausted the budget
    assert launcher.restart_stats()["restarts"] == {"worker": 1}
    assert not any(p.is_alive() for p in launcher.processes.values())


def test_no_policy_means_fail_fast():
    program = Program("failfast")
    program.add_node("worker", _AlwaysCrash, role="worker")
    launcher = MultiprocessLauncher(program).launch()
    with pytest.raises(Exception, match="crash"):
        launcher.join(timeout=JOIN_S)
    assert launcher.restart_stats()["restarts"] == {}


def test_stop_while_a_respawn_is_due_spawns_nothing():
    """A death seen while a respawn is scheduled far off, then a stop: the
    due respawn is dropped (no child starts after the stop went out), and
    stop and join return promptly and twice over."""
    program = Program("stop_due")
    program.restart_policy = RestartPolicy(max_restarts=3,
                                           backoff_base_s=30.0,
                                           backoff_max_s=30.0)
    program.add_node("worker", _SlowCrash, role="worker")
    launcher = MultiprocessLauncher(program).launch()
    first = launcher.processes["worker"]
    assert _wait_for(lambda: launcher.restart_stats()["restarts"]
                     == {"worker": 1}), launcher.restart_stats()
    t0 = time.monotonic()
    launcher.stop()
    launcher.stop()
    launcher.join(timeout=JOIN_S)
    launcher.join(timeout=JOIN_S)
    assert time.monotonic() - t0 < 10.0
    assert launcher.processes["worker"] is first   # nothing respawned
    assert launcher._respawn_at == {}
    assert not launcher._monitor_thread.is_alive()


def test_a_spawn_after_the_stop_relay_is_refused():
    """The stop's relay to the children and a respawn take turns: once the
    relay has gone out, ``_spawn`` starts no child (it would never hear of
    the stop)."""
    program, launcher = _elastic_program(_CrashOnce, RestartPolicy())
    launcher._payloads["worker"] = pickle.dumps(
        (_Reports, (), {}), protocol=pickle.HIGHEST_PROTOCOL)
    launcher.stop()
    assert launcher._spawn("worker", restarts=1) is False
    assert launcher.processes == {}
    launcher.join(timeout=JOIN_S)


# ================================================== simulated service death
def test_table_mark_down_blocks_data_path_not_control_path():
    table = Table("t", 16, Uniform(0), MinSize(1))
    table.insert("x")
    table.mark_down()
    with pytest.raises(ServiceUnavailable, match="down"):
        table.insert("y")
    with pytest.raises(ServiceUnavailable, match="down"):
        table.sample(1)
    with pytest.raises(ServiceUnavailable, match="down"):
        table.update_priorities([0], [1.0])
    # the watchdog, telemetry probes, and checkpointer still need these
    assert table.size() == 1
    state = table.state_dict()
    table.mark_up()
    table.insert("y")
    assert table.size() == 2
    restored = Table("t", 16, Uniform(0), MinSize(1))
    restored.load_state_dict(state)
    assert restored.size() == 1


def test_counter_recoverable_roundtrip():
    counter = Counter()
    counter.increment(actor_steps=10, episodes=2)
    assert is_recoverable(counter)
    state = counter.state_dict()
    restored = Counter()
    restored.load_state_dict(state)
    assert restored.get_counts() == counter.get_counts()
    assert service_activity(counter) == 12


def test_service_activity_reads_each_kind_of_service():
    table = Table("t", 16, Uniform(0), MinSize(1))
    for i in range(3):
        table.insert(i)
    table.sample(2)
    assert service_activity(table) == 5          # inserts + sampled items
    service = AsyncParameterService(2)
    service.push(0, {"w": torch.tensor(1.0)}, 1)
    service.pull()
    assert service_activity(service) == 2        # pushes + pulls
    worker = LearnerReplicaWorker(learner=None)
    worker.steps_taken = 7
    assert service_activity(worker) == 7
    assert service_activity(object()) == 0


def test_sharded_replay_shard_failover_matches_uninterrupted():
    """Kill + snapshot-restore of one shard leaves the sharded service in
    lock-step with a never-interrupted twin: same global keys, the same
    sample stream, the same priorities."""
    def build():
        return make_replay_shards(
            lambda: Table("s", 64, Prioritized(0.6, seed=3), MinSize(1)), 2)

    live, ref = build(), build()
    for i in range(12):
        assert live.insert(i, priority=1.0 + i) \
            == ref.insert(i, priority=1.0 + i)
    shard = live.shards[0]
    state = pickle.loads(pickle.dumps(shard.state_dict()))
    shard.mark_down()
    with pytest.raises(ServiceUnavailable):
        shard.insert("lost")
    shard.load_state_dict(state)
    shard.mark_up()
    for i in range(12, 20):
        assert live.insert(i, priority=0.5) == ref.insert(i, priority=0.5)
    keys = [0, 1, 2, 3]
    live.update_priorities(keys, [9.0, 8.0, 7.0, 6.0])
    ref.update_priorities(keys, [9.0, 8.0, 7.0, 6.0])
    for _ in range(15):
        a = [(it.key, it.data, prob) for it, prob in live.sample(3)]
        b = [(it.key, it.data, prob) for it, prob in ref.sample(3)]
        assert a == b


def test_metrics_pusher_survives_dead_hub_and_recovers():
    from repro_torch.telemetry import registry as _registry
    from repro_torch.telemetry.hub import MetricsHub, MetricsPusher

    class _FlakyHub:
        def __init__(self, failures):
            self.failures = failures
            self.hub = MetricsHub()

        def push(self, node, snapshot):
            if self.failures > 0:
                self.failures -= 1
                raise ConnectionError("hub is restarting")
            return self.hub.push(node, snapshot)

    _registry.configure(enabled=True, node="pusher_test")
    flaky = _FlakyHub(failures=3)
    pusher = MetricsPusher(flaky, "pusher_test", period_s=0.02).start()
    try:
        assert _wait_for(lambda: flaky.hub.num_pushes() > 0, timeout=10)
    finally:
        pusher.stop()
        _registry.unconfigure()
    assert pusher.push_failures >= 3
    assert "pusher_test" in flaky.hub.nodes()


# ==================================================== parameter servers
def _ps_state(x):
    return {"w": torch.tensor(x, dtype=torch.float32)}


def test_worker_mark_down_invalidates_parked_contribution():
    class _Recorder:
        def __init__(self):
            self.invalidated = []

        def invalidate(self, replica_id):
            self.invalidated.append(replica_id)

    recorder = _Recorder()
    worker = LearnerReplicaWorker(learner=None, param_server=recorder,
                                  replica_id=3)
    worker.mark_down()
    assert recorder.invalidated == [3]
    worker.mark_up()


def test_param_server_default_barrier_still_blocks():
    """No quorum knobs -> the strict all-or-nothing barrier."""
    ps = ParameterServer(2, 1)
    done = threading.Event()

    def first():
        ps.sync(0, _ps_state(1.0))
        done.set()

    threading.Thread(target=first, daemon=True).start()
    assert not done.wait(0.4), "strict barrier released with 1/2 replicas"
    assert float(ps.sync(1, _ps_state(3.0))["w"]) == 2.0
    assert done.wait(JOIN_S)
    assert "quorum_merges" not in ps.stats()


def test_param_server_quorum_round_merges_once_not_twice():
    """Exactly ``min_quorum`` contributions arriving just under
    ``barrier_timeout_s`` merge ONCE — the straggler that shows up after
    the deadline adopts, and the blend is untouched."""
    ps = ParameterServer(3, 1, barrier_timeout_s=0.4, min_quorum=2)
    results = {}

    def contribute(rid, x):
        results[rid] = ps.sync(rid, _ps_state(x))

    t0 = threading.Thread(target=contribute, args=(0, 1.0))
    t0.start()
    time.sleep(0.3)
    t1 = threading.Thread(target=contribute, args=(1, 3.0))
    t1.start()
    t0.join(JOIN_S)
    t1.join(JOIN_S)
    assert not t0.is_alive() and not t1.is_alive()
    assert float(results[0]["w"]) == float(results[1]["w"]) == 2.0
    stats = ps.stats()
    assert stats["rounds"] == 1
    assert stats["quorum_merges"] == 1
    assert float(ps.sync(2, _ps_state(9.0))["w"]) == 2.0
    assert ps.rounds == 1
    assert ps.stats()["stale_adoptions"] == 1


def test_param_server_quorum_validation():
    with pytest.raises(ValueError, match="barrier_timeout_s"):
        ParameterServer(2, 1, barrier_timeout_s=0.0)
    with pytest.raises(ValueError, match="min_quorum"):
        ParameterServer(2, 1, min_quorum=1)           # timeout missing
    with pytest.raises(ValueError, match="min_quorum"):
        ParameterServer(2, 1, barrier_timeout_s=1.0, min_quorum=3)


# ================================================= the service watchdog
class _FakeLauncher:
    """Just enough launcher surface for a ServiceWatchdog unit test."""

    def __init__(self, servers):
        self._servers = servers
        self.errors = []
        self.stopping = False

    def should_stop(self):
        return self.stopping

    def _record_error(self, error):
        self.errors.append(error)


def _watchdog(launcher, tmp_path=None, **policy):
    policy = RestartPolicy(**dict(dict(max_restarts=2, backoff_base_s=0.05),
                                  **policy))
    return ServiceWatchdog(launcher, policy, snapshot_period_s=0.05,
                           snapshot_dir=str(tmp_path) if tmp_path else None)


def test_service_watchdog_kill_restores_snapshot_at_same_address(tmp_path):
    table = Table("t", 32, Uniform(0), MinSize(1))
    server, handle = courier.serve(
        table, interface=("insert", "sample", "size"), name="replay/shard_0")
    launcher = _FakeLauncher({"replay/shard_0": server})
    wd = _watchdog(launcher, tmp_path)
    wd.register("replay/shard_0", table)
    wd.start()
    try:
        for i in range(5):
            handle.insert(i)
        wd.snapshot_now()          # deterministic cut: 5 items on disk
        table.insert("lost")       # arrives after the snapshot -> rolled back
        wd.kill("replay/shard_0", exit_code=42)
        with pytest.raises(ServiceUnavailable):
            table.insert("down")
        assert _wait_for(lambda: launcher._servers["replay/shard_0"]
                         is not server), \
            f"service never respawned; errors={launcher.errors}"
        assert launcher._servers["replay/shard_0"].address == server.address
        assert handle.size() == 5
        handle.insert("after")
        assert handle.size() == 6
    finally:
        wd.join(timeout=JOIN_S)
        launcher._servers["replay/shard_0"].stop()
    stats = wd.stats()
    assert stats["service_restarts"] == {"replay/shard_0": 1}
    assert stats["service_exit_kinds"]["replay/shard_0"] == [CRASH]
    assert launcher.errors == []


def test_service_watchdog_restores_async_param_service_same_address(
        tmp_path):
    """The ``learner/param_service`` node fails over like any other
    service: the watchdog kills it, restores the snapshot's contributions
    onto their device, and re-binds at the SAME courier address."""
    service = AsyncParameterService(num_replicas=2, merge="mean")
    server, handle = courier.serve(
        service, interface=ASYNC_PARAM_SERVICE_INTERFACE + ("activity",),
        name="learner/param_service")
    launcher = _FakeLauncher({"learner/param_service": server})
    wd = _watchdog(launcher, tmp_path)
    wd.register("learner/param_service", service)
    wd.start()
    try:
        handle.push(0, _ps_state(2.0), 10)
        handle.push(1, _ps_state(4.0), 10)
        assert float(handle.pull()["w"]) == 3.0
        wd.snapshot_now()
        service.push(0, _ps_state(100.0), 11)   # post-snapshot -> rolled back
        wd.kill("learner/param_service", exit_code=42)
        with pytest.raises(ServiceUnavailable):
            service.pull()
        assert _wait_for(lambda: launcher._servers["learner/param_service"]
                         is not server), \
            f"service never respawned; errors={launcher.errors}"
        respawned = launcher._servers["learner/param_service"]
        assert respawned.address == server.address
        assert float(handle.pull()["w"]) == 3.0
        handle.push(1, _ps_state(6.0), 12)
        assert float(handle.pull()["w"]) == 4.0
    finally:
        wd.join(timeout=JOIN_S)
        launcher._servers["learner/param_service"].stop()
    assert wd.stats()["service_restarts"] == {"learner/param_service": 1}
    assert launcher.errors == []


def test_service_watchdog_budget_exhaustion_records_error(tmp_path):
    table = Table("t", 8, Uniform(0), MinSize(1))
    launcher = _FakeLauncher({})
    wd = _watchdog(launcher, tmp_path, max_restarts=1, backoff_base_s=0.02)
    wd.register("replay", table)
    wd.start()
    try:
        wd.kill("replay", exit_code=42)
        assert _wait_for(lambda: wd.stats()["service_restarts"]
                         .get("replay") == 1)
        assert _wait_for(lambda: "replay" not in wd._down)
        wd.kill("replay", exit_code=42)   # second death exhausts the budget
        assert _wait_for(lambda: launcher.errors)
    finally:
        wd.join(timeout=JOIN_S)
    assert "not restartable" in str(launcher.errors[0])
    assert wd.stats()["service_exit_kinds"]["replay"] == [CRASH, CRASH]


def test_service_watchdog_kill_while_stopping_is_teardown_noise(tmp_path):
    """A death seen while the launcher stops is not an incident: the
    service goes down, nothing is charged and nothing respawns."""
    table = Table("t", 8, Uniform(0), MinSize(1))
    launcher = _FakeLauncher({})
    wd = _watchdog(launcher, tmp_path)
    wd.register("replay", table)
    launcher.stopping = True
    wd.kill("replay", exit_code=42)
    assert wd.stats() == {"service_restarts": {}, "service_exit_kinds": {}}
    assert wd._respawn_at == {}
    with pytest.raises(ServiceUnavailable):
        table.insert(1)


def test_chaos_policy_service_schedules_target_services_only():
    policy = ChaosPolicy(kill_after_steps=100, kill_jitter_steps=10,
                         kill_targets=("replay/shard_0",), seed=7)
    assert policy.service_schedule_for("replay/shard_1") is None
    schedule = policy.service_schedule_for("replay/shard_0")
    assert schedule is not None
    assert 100 <= schedule.kill_step <= 110
    assert policy.service_schedule_for("replay/shard_0").kill_step \
        == schedule.kill_step
    assert schedule.fired == 0

    class _NoDown:
        def state_dict(self):
            return {}

        def load_state_dict(self, state):
            pass

    wd = ServiceWatchdog(_FakeLauncher({}), RestartPolicy(), chaos=policy)
    with pytest.raises(ValueError, match="mark_down"):
        wd.register("replay/shard_0", _NoDown())
    wd.join()


def test_service_watchdog_fires_a_chaos_kill_on_activity(tmp_path):
    """A service kill schedule fires once the target's activity passes its
    kill step, once (``max_kills``), and the service comes back."""
    table = Table("t", 32, Uniform(0), MinSize(1))
    launcher = _FakeLauncher({})
    chaos = ChaosPolicy(kill_after_steps=5, kill_targets=("replay",))
    wd = ServiceWatchdog(launcher, RestartPolicy(backoff_base_s=0.02),
                         chaos=chaos, snapshot_period_s=0.05,
                         snapshot_dir=str(tmp_path))
    wd.register("replay", table)
    wd.start()
    try:
        for i in range(6):
            table.insert(i)
        assert _wait_for(lambda: wd.stats()["service_restarts"]
                         .get("replay") == 1)
        assert _wait_for(lambda: "replay" not in wd._down)
        for i in range(20):
            table.insert(i)
        time.sleep(0.3)
    finally:
        wd.join(timeout=JOIN_S)
    assert wd.stats()["service_restarts"] == {"replay": 1}
    assert launcher.errors == []


def test_service_watchdog_removes_the_snapshot_directory_it_made():
    wd = ServiceWatchdog(_FakeLauncher({}), RestartPolicy(),
                         snapshot_period_s=0.05)
    wd.register("counter", Counter())
    wd.start()
    assert _wait_for(lambda: os.listdir(wd._dir))
    wd.join(timeout=JOIN_S)
    assert not os.path.exists(wd._dir)


# ============================================================== HostTree
def _mixed_tree():
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    return types.Transition(
        observation={"a": torch.randn(3, 5), "scalar": torch.tensor(2.5),
                     "empty": torch.zeros(0, 3)},
        action=torch.tensor([1, -2, 3], dtype=torch.int32),
        reward=base.t()[1:, ::2],            # a non-contiguous view
        discount=torch.tensor([True, False, True]),
        next_observation=(np.arange(3), 7, "label",
                          torch.tensor(2 ** 40, dtype=torch.int64),
                          torch.ones(5, dtype=torch.bfloat16)),
        extras=())


def test_host_tree_restores_every_leaf_in_its_dtype_shape_and_device():
    state = _mixed_tree()
    snapshot = pickle.loads(pickle.dumps(HostTree(state)))
    restored = snapshot.restore()
    assert type(restored) is type(state)
    flat, ref = tree.leaves(restored), tree.leaves(state)
    assert len(flat) == len(ref)
    for a, b in zip(flat, ref):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.device == b.device and torch.equal(a, b)
        else:
            assert np.array_equal(a, b) if isinstance(b, np.ndarray) \
                else a == b


def test_host_tree_copies_once_a_device_and_pickles_as_bytes(monkeypatch):
    """Every tensor leaf of a state reaches the host in one transfer: one
    concatenation of the leaves' bytes, one buffer, no tensor left in the
    pickle."""
    cats = []
    real_cat = torch.cat
    monkeypatch.setattr(torch, "cat",
                        lambda parts, *a, **k: cats.append(len(parts))
                        or real_cat(parts, *a, **k))
    snapshot = HostTree(_mixed_tree())
    assert len(cats) == 1
    assert list(snapshot.buffers) == ["cpu"]
    assert isinstance(snapshot.buffers["cpu"], np.ndarray)
    assert all(not isinstance(leaf, torch.Tensor)
               for leaf in snapshot.leaves)
    assert b"torch" not in pickle.dumps(snapshot.buffers)


def test_host_tree_of_a_learner_state_is_the_state():
    builder = DQNBuilder(make_environment_spec(Catch(seed=0)),
                         DQNConfig(**SMALL), seed=0, device="cpu")
    state = builder.make_learner(iter(())).state
    restored = HostTree(state).restore()
    for a, b in zip(tree.leaves(restored), tree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ============================================= learner replicas fail over
def _batches(count, seed=0):
    out = []
    for b in range(count):
        rng = np.random.RandomState(seed * 1000 + b)
        fields = (rng.rand(8, 10, 5).astype(np.float32),
                  rng.randint(0, 3, size=8).astype(np.int32),
                  rng.randn(8).astype(np.float32),
                  np.ones(8, np.float32),
                  rng.rand(8, 10, 5).astype(np.float32))
        out.append(ReplaySample(
            SampleInfo(np.arange(8, dtype=np.int64), np.full(8, 1.0 / 64)),
            types.Transition(*fields, ())))
    return out


def _endless(batches):
    while True:
        yield from batches


class _SlowLearner:
    """Wraps a learner so a step takes a while (a kill lands mid-step)."""

    def __init__(self, learner, step_s):
        self.learner = learner
        self.step_s = step_s

    @property
    def state(self):
        return self.learner.state

    @state.setter
    def state(self, value):
        self.learner.state = value

    def step(self):
        time.sleep(self.step_s)
        return self.learner.step()

    def get_variables(self, names=()):
        return self.learner.get_variables(names)


def test_watchdog_kill_of_a_live_replica_restores_the_snapshot_leaf_for_leaf(
        tmp_path):
    """A replica stepping DQN in its own thread is snapshotted, killed
    while a step is in flight, and restored: its state equals the snapshot
    leaf for leaf (the step in flight did not overwrite it), its step count
    resumes from the snapshot's, and it steps on after ``mark_up``."""
    builder = DQNBuilder(make_environment_spec(Catch(seed=0)),
                         DQNConfig(**SMALL), seed=0, device="cpu")
    learner = _SlowLearner(builder.make_learner(_endless(_batches(4))), 0.05)
    service = AsyncParameterService(2)
    replica = LearnerReplicaWorker(learner, service, replica_id=1,
                                   average_period=2, sync_mode="async")
    launcher = _FakeLauncher({})
    wd = ServiceWatchdog(launcher, RestartPolicy(backoff_base_s=0.01),
                         snapshot_period_s=60.0, snapshot_dir=str(tmp_path))
    wd.register("learner/replica_1", replica)
    thread = threading.Thread(target=replica.run, daemon=True)
    thread.start()
    try:
        assert _wait_for(lambda: replica.steps_taken >= 3)
        wd.snapshot_now()
        with open(wd._snapshot_path("learner/replica_1"), "rb") as f:
            snapshot = pickle.load(f)
        cut = snapshot["learner_state"].restore()
        assert _wait_for(lambda: replica.steps_taken
                         >= snapshot["steps_taken"] + 2)
        wd.kill("learner/replica_1", exit_code=42)
        assert service.stats()["contributors"] == 0   # withdrawn at kill
        wd._respawn("learner/replica_1")     # restore at once, mid-step
        restored = replica.learner.state
        for a, b in zip(tree.leaves(restored), tree.leaves(cut)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert replica.steps_taken == snapshot["steps_taken"]
        assert _wait_for(lambda: replica.steps_taken
                         > snapshot["steps_taken"])
    finally:
        replica.stop()
        thread.join(JOIN_S)
        wd.join(timeout=JOIN_S)
    assert not thread.is_alive()
    assert launcher.errors == []


def test_replica_degrades_while_its_exchange_is_down():
    """With the async service down, a replica skips its exchanges (counted
    as skipped steps) and keeps training; it rejoins once the service is
    up again."""
    from repro_torch.telemetry import registry as _registry

    builder = DQNBuilder(make_environment_spec(Catch(seed=0)),
                         DQNConfig(**SMALL), seed=0, device="cpu")
    service = AsyncParameterService(1)
    service.mark_down()
    replica = LearnerReplicaWorker(
        builder.make_learner(_endless(_batches(4))), service, replica_id=0,
        average_period=1, sync_mode="async", max_steps=6)
    _registry.configure(enabled=True, node="degrade_test")
    try:
        replica.run()
        skipped = _registry.snapshot()[
            "resilience/learner_replica_0/skipped_steps"]["value"]
    finally:
        _registry.unconfigure()
    assert replica.steps_taken == 6 and skipped == 6
    assert service.stats()["pushes"] == 0
    service.mark_up()
    replica.max_steps = 7
    replica.run()
    assert service.stats()["pushes"] == 1


# ======================================== learners swap, never write in place
@pytest.mark.parametrize("make_config", [make_dqn_catch_config,
                                         make_transformer_catch_config],
                         ids=["dqn", "transformer_policy"])
def test_learner_step_never_writes_its_state_in_place(make_config):
    """A learner step builds a new state and leaves every leaf of the old
    one as it was, so a snapshot (or a parked contribution) taken from the
    state a replica held is a consistent state whatever the replica does
    next."""
    result = run_experiment(make_config(seed=0, num_episodes=6,
                                        eval_episodes=0))
    learner = result.learner
    assert result.learner_steps > 0
    for _ in range(3):
        before = learner.state
        copies = [leaf.clone() for leaf in tree.leaves(before)]
        learner.step()
        assert learner.state is not before
        for leaf, copy in zip(tree.leaves(before), copies):
            assert torch.equal(leaf, copy)


# ======================================== run checkpoints around a run
def test_sharded_replay_roundtrip_rejects_shard_mismatch():
    src = make_replay_shards(lambda: Table("s", 8, Uniform(0), MinSize(1)),
                             2)
    dst = make_replay_shards(lambda: Table("s", 8, Uniform(0), MinSize(1)),
                             3)
    with pytest.raises(ValueError, match="shard count"):
        dst.load_state_dict(src.state_dict())


def test_run_experiment_final_save_dedupes_against_cadence(tmp_path,
                                                          monkeypatch):
    """With a per-episode cadence the final checkpoint is the cadence
    checkpoint — run_experiment does not write it twice; with no cadence it
    writes exactly one (final) save."""
    from repro_torch.resilience import run_checkpoint

    saves = []
    original = run_checkpoint.RunCheckpointer.save

    def counting_save(self, step, learner_state, **kwargs):
        saves.append(int(step))
        return original(self, step, learner_state, **kwargs)

    monkeypatch.setattr(run_checkpoint.RunCheckpointer, "save",
                        counting_save)
    result = run_experiment(make_dqn_catch_config(
        seed=0, min_replay_size=10, num_episodes=6, eval_episodes=0,
        checkpoint_dir=str(tmp_path), checkpoint_every=1))
    assert saves, "cadence checkpoints never fired"
    assert saves[-1] == result.learner_steps
    assert len(saves) == len(set(saves))
    saves.clear()
    run_experiment(make_dqn_catch_config(
        seed=0, min_replay_size=10, num_episodes=3, eval_episodes=0,
        checkpoint_dir=str(tmp_path / "b")))
    assert len(saves) == 1


def test_run_distributed_experiment_resumes_counts(tmp_path):
    """A distributed run resumes from its run checkpoint: a sentinel count
    written into the snapshot reaches the resumed run's counter, and the
    learner's step counter continues."""
    from repro_torch.experiments import run_distributed_experiment
    from repro_torch.resilience import RunCheckpointer

    cfg = make_dqn_catch_config(seed=0, min_replay_size=20, eval_episodes=0,
                                checkpoint_dir=str(tmp_path))
    first = run_distributed_experiment(cfg, num_actors=2,
                                       max_actor_steps=300, timeout_s=90)
    assert (tmp_path / "run_latest.json").exists()
    first_steps = int(first.counts["actor_steps"])
    ck = RunCheckpointer(str(tmp_path))
    snap = ck.restore(first.learner.state)
    counts = dict(snap.counts)
    counts["resume_sentinel"] = 123.0
    ck.save(snap.step, snap.learner_state, replay=snap.replay, counts=counts)
    resumed = run_distributed_experiment(
        dataclasses.replace(cfg, resume=True), num_actors=2,
        max_actor_steps=first_steps + 50, timeout_s=90)
    assert resumed.counts.get("resume_sentinel") == 123.0
    assert resumed.counts["actor_steps"] >= first_steps + 50
    assert resumed.learner_steps >= first.learner_steps
