"""Service failover: snapshot, kill-detect, and respawn for stateful
parent-resident services.

The multiprocess launcher makes *workers* elastic — spawned processes
respawn from their pickled payloads.  Services are different: they are parent-resident objects behind
courier ``Server``s (replay shards, the counter, learner replicas), so a
"death" cannot be a SIGKILL of some child pid.  The ``ServiceWatchdog``
simulates the same client-visible failure surface instead:

- **kill**: ``mark_down()`` the instance (in-parent callers see
  ``ServiceUnavailable`` on the data path) and stop its courier server
  (remote callers see connection-refused), then classify the synthetic
  exit code with ``classify_exit`` and charge the ``RestartPolicy`` budget
  exactly like a dead worker.
- **respawn**: after the policy's backoff, restore the last periodic
  snapshot via ``load_state_dict()`` (writes since the snapshot are lost —
  the realistic contract), ``mark_up()``, and re-bind a courier ``Server``
  at the SAME address with the SAME authkey, so every pickled
  ``RemoteHandle`` in the fleet reconnects without re-resolution.

Snapshots reuse the temp + fsync + ``os.replace`` discipline from
``run_checkpoint`` — a crash mid-write leaves the previous snapshot
intact.  Any object with ``state_dict()`` / ``load_state_dict()`` is
*recoverable*; ``mark_down()`` / ``mark_up()`` additionally make it a
valid chaos kill target.

A service whose state holds tensors on the card (learner replicas, the
async parameter service) snapshots it through ``HostTree``: every tensor
leaf of one state goes to the host in ONE copy (a byte concatenation on
the device, then one transfer), so the watchdog thread waits for the
device once a state instead of once a leaf, and the pickle holds plain
bytes.  ``HostTree.restore()`` puts every leaf back on the device and in
the dtype it was cut from; the services restore before ``mark_up``, so a
client never sees a half-restored instance.  The watchdog times each
snapshot and restore (host ms, pickle and file included) into the
``resilience/snapshot_ms`` and ``resilience/restore_ms`` histograms, over
all services and per service (``.../<node name>``).
"""
from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.resilience.supervisor import RestartPolicy, classify_exit
from repro_torch.telemetry import registry as _telemetry

# How often the watchdog snapshots each live recoverable service.
DEFAULT_SNAPSHOT_PERIOD_S = 0.5

# Each leaf's bytes start at a multiple of this in a HostTree buffer, so
# every leaf is a valid view of the buffer in its own dtype.
_ALIGN = 16


class HostTree:
    """A tree with its tensor leaves copied to the host, one copy a device.

    ``HostTree(state)`` flattens ``state`` (``repro_torch.tree``, JAX
    order), concatenates the bytes of its tensor leaves on each device the
    leaves live on (padded to ``_ALIGN``) and brings each concatenation to
    the host in one transfer; other leaves are kept as they are.  It
    pickles as plain bytes.  ``restore()`` rebuilds the tree with every
    tensor leaf on its own device and in its own dtype and shape: one
    upload a device, each leaf a view of it (the port's learners replace
    their state each step and never write a leaf in place).
    """

    def __init__(self, state):
        leaves, self.treedef = tree.flatten(state)
        self.leaves: List[Any] = list(leaves)
        self.tensors: List[tuple] = []   # (index, device, dtype, shape, offset, nbytes)
        parts: Dict[str, list] = {}
        sizes: Dict[str, int] = {}
        pads: Dict[str, torch.Tensor] = {}
        for i, leaf in enumerate(leaves):
            if not isinstance(leaf, torch.Tensor):
                continue
            device = str(leaf.device)
            flat = leaf.detach().reshape(-1).view(torch.uint8)
            offset = sizes.get(device, 0)
            nbytes = flat.numel()
            self.tensors.append((i, device, leaf.dtype, tuple(leaf.shape),
                                 offset, nbytes))
            self.leaves[i] = None
            pad = -nbytes % _ALIGN
            if device not in pads:
                pads[device] = torch.zeros(_ALIGN, dtype=torch.uint8,
                                           device=leaf.device)
            parts.setdefault(device, []).extend(
                [flat, pads[device][:pad]] if pad else [flat])
            sizes[device] = offset + nbytes + pad
        self.buffers: Dict[str, np.ndarray] = {
            device: torch.cat(chunks).cpu().numpy()
            for device, chunks in parts.items()}

    def restore(self):
        """The tree, each tensor leaf back on its device in its dtype."""
        uploads = {device: torch.from_numpy(buf).to(device)
                   for device, buf in self.buffers.items()}
        leaves = list(self.leaves)
        for i, device, dtype, shape, offset, nbytes in self.tensors:
            leaves[i] = (uploads[device][offset:offset + nbytes]
                         .view(dtype).view(shape))
        return tree.unflatten(self.treedef, leaves)


def is_recoverable(instance: Any) -> bool:
    """True if the object carries restorable state: callable
    ``state_dict()`` and ``load_state_dict()``."""
    return (callable(getattr(instance, "state_dict", None))
            and callable(getattr(instance, "load_state_dict", None)))


def supports_down(instance: Any) -> bool:
    """True if the object can simulate death: callable ``mark_down()`` and
    ``mark_up()``."""
    return (callable(getattr(instance, "mark_down", None))
            and callable(getattr(instance, "mark_up", None)))


def service_activity(instance: Any) -> int:
    """A monotonic activity counter for chaos kill triggers.

    Services have no ``observe()`` to wrap (clients reach replay shards
    through direct in-memory refs, so a proxy would be bypassed), so kill
    schedules trigger on the service's own progress: services exposing an
    ``activity()`` counter (the async parameter service counts pushes +
    pulls) report it directly, replay tables count rate-limiter inserts +
    samples, learner replicas count steps taken, counters count their
    totals.
    """
    activity = getattr(instance, "activity", None)
    if callable(activity):
        return int(activity())
    limiter = getattr(instance, "rate_limiter", None)
    if limiter is not None:
        return int(limiter.inserts + limiter.samples)
    steps = getattr(instance, "steps_taken", None)
    if steps is not None:
        return int(steps)
    get_counts = getattr(instance, "get_counts", None)
    if callable(get_counts):
        return int(sum(get_counts().values()))
    return 0


def atomic_pickle(path: str, obj: Any):
    """Pickle ``obj`` to ``path`` crash-safely (temp + fsync + replace)."""
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-",
                               suffix=".pkl")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class ServiceWatchdog:
    """Parent-side supervisor for ``role="service"`` nodes.

    Runs one daemon thread that (1) snapshots every registered recoverable
    service each ``snapshot_period_s``, (2) fires ``ServiceKillSchedule``s
    from the program's ``ChaosPolicy`` once a target's activity passes its
    kill step, and (3) performs due respawns.  Restart accounting mirrors
    the worker monitor: ``classify_exit`` on the synthetic exit code,
    ``RestartPolicy.should_restart`` against a per-service budget,
    exponential backoff between death and respawn, and a fail-fast
    ``_record_error`` on the owning launcher when the budget is exhausted.
    """

    def __init__(self, launcher, policy: RestartPolicy, chaos=None,
                 snapshot_period_s: float = DEFAULT_SNAPSHOT_PERIOD_S,
                 snapshot_dir: Optional[str] = None):
        if snapshot_period_s <= 0:
            raise ValueError(f"snapshot_period_s must be > 0, "
                             f"got {snapshot_period_s}")
        self._launcher = launcher
        self._policy = policy
        self._chaos = chaos
        self._period = snapshot_period_s
        # a directory made here is the watchdog's own, removed by join()
        self._own_dir = snapshot_dir is None
        self._dir = snapshot_dir or tempfile.mkdtemp(prefix="repro-failover-")
        self._services: Dict[str, Any] = {}
        self._schedules: Dict[str, Any] = {}
        self._rebind: Dict[str, tuple] = {}
        self._down: set = set()
        self._respawn_at: Dict[str, float] = {}
        self._restarts: Dict[str, int] = {}
        self._exit_kinds: Dict[str, list] = {}
        self._last_snapshot_at = 0.0
        self._snapshot_warned = False
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- registration / lifecycle -------------------------------------

    def register(self, name: str, instance: Any):
        """Track a service node.  Recoverable instances are snapshotted;
        chaos kill targets must additionally support mark_down/mark_up."""
        if instance is None:
            return
        if is_recoverable(instance):
            self._services[name] = instance
        if self._chaos is not None:
            schedule = self._chaos.service_schedule_for(name)
            if schedule is not None:
                if not supports_down(instance):
                    raise ValueError(
                        f"chaos kill target {name!r} is a service without "
                        f"mark_down()/mark_up() — it cannot simulate death")
                self._schedules[name] = schedule

    def start(self) -> "ServiceWatchdog":
        self._thread = threading.Thread(
            target=self._run, name="launcher/service-watchdog", daemon=True)
        self._thread.start()
        return self

    def request_stop(self):
        """Signal the thread to exit (non-blocking; safe from any thread,
        including the watchdog's own error path)."""
        self._stop.set()

    def join(self, timeout: Optional[float] = None):
        self.request_stop()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._own_dir and not (self._thread and self._thread.is_alive()):
            shutil.rmtree(self._dir, ignore_errors=True)

    # -- stats ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "service_restarts": dict(self._restarts),
                "service_exit_kinds": {n: list(k)
                                       for n, k in self._exit_kinds.items()},
            }

    # -- the loop ------------------------------------------------------

    def _run(self):
        while not self._stop.wait(0.05):
            try:
                self._tick()
            except Exception as e:  # a watchdog bug must fail loudly
                self._launcher._record_error(RuntimeError(
                    f"service watchdog died: {type(e).__name__}: {e}"))
                return

    def _tick(self):
        if self._launcher.should_stop():
            self._stop.set()
            return
        now = time.monotonic()
        for name, schedule in list(self._schedules.items()):
            with self._lock:
                busy = name in self._down or name in self._respawn_at
            if busy or schedule.fired >= schedule.max_kills:
                continue
            if service_activity(self._get_instance(name)) >= schedule.kill_step:
                schedule.fired += 1
                self.kill(name, schedule.exit_code)
        with self._lock:
            due = [n for n, at in self._respawn_at.items() if now >= at]
        for name in due:
            with self._lock:
                self._respawn_at.pop(name, None)
            self._respawn(name)
        if now - self._last_snapshot_at >= self._period:
            self._last_snapshot_at = now
            self.snapshot_now()

    def _get_instance(self, name: str) -> Any:
        instance = self._services.get(name)
        if instance is None:
            node = self._launcher.program.node(name)
            instance = node.instance
        return instance

    def _snapshot_path(self, name: str) -> str:
        return os.path.join(self._dir, name.replace("/", "__") + ".pkl")

    def snapshot_now(self):
        """Snapshot every live recoverable service (also called on the
        periodic cadence; public so tests can force a deterministic cut)."""
        for name, instance in self._services.items():
            with self._lock:
                if name in self._down or name in self._respawn_at:
                    continue
            try:
                t0 = time.monotonic()
                state = instance.state_dict()
                atomic_pickle(self._snapshot_path(name), state)
                self._observe_ms("resilience/snapshot_ms", t0, name)
            except Exception as e:
                if not self._snapshot_warned:
                    self._snapshot_warned = True
                    print(f"[launcher] service snapshot of {name!r} failed "
                          f"({type(e).__name__}: {e}) — failover for it "
                          f"would restore an older snapshot",
                          file=sys.stderr, flush=True)

    # -- kill / respawn ------------------------------------------------

    def kill(self, name: str, exit_code: int = 1):
        """Simulate abrupt death of service ``name``: mark it down, tear
        down its courier server, and schedule a budgeted respawn."""
        instance = self._get_instance(name)
        if instance is None:
            raise ValueError(f"unknown service {name!r}")
        stopping = self._launcher.should_stop()
        with self._lock:
            if name in self._down:
                return
            self._down.add(name)
        if supports_down(instance):
            instance.mark_down()
        server = self._launcher._servers.get(name)
        if server is not None:
            with self._lock:
                self._rebind[name] = (server.address, server.authkey,
                                      server.interface)
            server.stop()
        if stopping:
            return  # teardown noise — no accounting, no respawn
        kind = classify_exit(exit_code, stopping=False)
        with self._lock:
            self._exit_kinds.setdefault(name, []).append(kind)
            count = self._restarts.get(name, 0)
            restart = self._policy.should_restart(kind, count)
            if restart:
                delay = self._policy.backoff(count)
                self._restarts[name] = count + 1
                self._respawn_at[name] = time.monotonic() + delay
        if restart:
            print(f"[launcher] service {name!r} died ({kind}, exit "
                  f"{exit_code}) — restoring from snapshot in {delay:.2f}s "
                  f"(restart {count + 1}/{self._policy.max_restarts})",
                  flush=True)
        else:
            self._launcher._record_error(RuntimeError(
                f"service {name!r} died ({kind}, exit {exit_code}) and is "
                f"not restartable under the policy "
                f"(restarts={count}/{self._policy.max_restarts})"))

    def _respawn(self, name: str):
        if self._launcher.should_stop():
            return
        instance = self._get_instance(name)
        path = self._snapshot_path(name)
        if is_recoverable(instance) and os.path.exists(path):
            try:
                t0 = time.monotonic()
                with open(path, "rb") as f:
                    state = pickle.load(f)
                instance.load_state_dict(state)
                self._observe_ms("resilience/restore_ms", t0, name)
            except Exception as e:
                self._launcher._record_error(RuntimeError(
                    f"restoring service {name!r} from its snapshot failed: "
                    f"{type(e).__name__}: {e}"))
                return
        # state restored BEFORE the service comes back up: clients must
        # never observe a half-restored instance.
        if supports_down(instance):
            instance.mark_up()
        with self._lock:
            rebind = self._rebind.pop(name, None)
        if rebind is not None:
            address, authkey, interface = rebind
            try:
                from repro_torch.distributed.courier import Server
                server = Server(instance, interface=interface, name=name,
                                host=address[0], port=address[1],
                                authkey=authkey).start()
            except OSError:
                # the old port is still draining — retry shortly
                with self._lock:
                    self._rebind[name] = rebind
                    self._respawn_at[name] = time.monotonic() + 0.25
                return
            self._launcher._servers[name] = server
        with self._lock:
            self._down.discard(name)
        metrics = self._restarts_metric(name)
        if metrics:
            for m in metrics:
                m.inc()
        print(f"[launcher] service {name!r} restored and re-bound "
              f"at the same address", flush=True)

    def _observe_ms(self, metric: str, t0: float, name: str):
        """Host ms since ``t0`` into ``metric`` and ``metric/<name>``."""
        if not _telemetry.enabled():
            return
        ms = (time.monotonic() - t0) * 1e3
        _telemetry.histogram(metric).observe(ms)
        _telemetry.histogram(f"{metric}/{name}").observe(ms)

    def _restarts_metric(self, name: str):
        if not _telemetry.enabled():
            return None
        return (_telemetry.counter("resilience/service_restarts"),
                _telemetry.counter(f"resilience/service_restarts/{name}"))
