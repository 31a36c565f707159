"""Multi-learner execution: per-shard learner replicas with parameter
averaging (the distributed-learner half of the §2.4 scaling story).

Sharded replay scales the replay *service*; this module shards the
*learner*: N replicas, each consuming its own replay shard's dataset,
periodically merged by a ``ParameterServer`` so actors, evaluators, and
checkpoints still see ONE logical learner.

Components:

- ``average_states(states)`` — the element-wise tree mean over replica
  ``LearnerState``s (params, target params, optimizer moments, step
  counters), on the tensors' own device.  Float leaves accumulate in
  float32 in a left fold (the JAX package's order, so the result is the
  same bits) and cast back to their dtype; integer leaves (step counters)
  take an int64 floor mean, exact at any magnitude when replicas agree.  A
  single-state average is the identity (no float round-trip) — the
  1-replica configuration is bit-equivalent to the plain learner.
- ``ParameterServer`` — the averaging rendezvous.  ``sync(replica_id,
  state)`` blocks until every replica has contributed the current round,
  then returns the merged state to all of them (synchronous all-reduce-style
  parameter averaging).  ``stop()`` releases blocked callers with ``None``
  so replica teardown can never deadlock on a half-filled round.
- ``MultiLearner`` — the single-logical-learner facade.  In the
  single-process path it IS the agent's learner: ``step()`` steps replicas
  sequentially round-robin and averages in-line every ``average_period``
  per-replica steps.  In distributed programs the replicas step on their own
  nodes and the facade only serves ``get_variables`` (the merged params, as
  numpy) and ``state`` (the merged checkpoint view; assigning broadcasts a
  restore to every replica).  Deliberately NOT a ``Learner`` subclass: the
  ABC's concrete ``run(num_steps)`` would make launchers schedule the
  facade as a run-loop node.
- ``LearnerReplicaWorker`` — the program-graph node wrapping one replica:
  steps SGD until stopped, rendezvous at the parameter server every
  ``average_period`` steps, closes its prefetching dataset on stop.

Replicas and the parameter server are parent-resident services, so merged
states stay tensors on the learners' device and never cross courier.  The
barrier-free ``AsyncParameterService`` (``learner_sync="async"``), its
``weighted_average_states`` and the replicas' failover hooks come with
ROADMAP slice 7b.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import tree
from repro_torch.telemetry import registry as _telemetry

# The declared RPC surface of the parameter-server node (what a multi-host
# backend would let remote replicas call).
PARAM_SERVER_INTERFACE = ("sync", "stats")

# Learner synchronization modes the execution layers accept.
LEARNER_SYNC_MODES = ("barrier", "quorum", "async")


def average_states(states: Sequence[Any]):
    """Element-wise mean over a sequence of identically-structured trees of
    tensors, each leaf on its own device (no trip through the host).

    Float leaves accumulate in float32 in a left fold and cast back to their
    dtype; integer leaves (step counters) accumulate in int64 and take the
    floor mean — exact at ANY magnitude when the replicas agree (float32
    accumulation would silently round counters past 2^24).  With one state
    this is the identity — no round-trip, so 1-replica averaging is exactly
    the input state.
    """
    states = list(states)
    if not states:
        raise ValueError("average_states needs at least one state")
    if len(states) == 1:
        return states[0]

    def _mean(*leaves):
        first = torch.as_tensor(leaves[0])
        rest = [torch.as_tensor(leaf, device=first.device)
                for leaf in leaves[1:]]
        if not (first.is_floating_point() or first.dtype == torch.bool):
            total = first.to(torch.int64)
            for leaf in rest:
                total = total + leaf.to(torch.int64)
            return torch.div(total, len(leaves),
                             rounding_mode="floor").to(first.dtype)
        total = first.to(torch.float32)
        for leaf in rest:
            total = total + leaf.to(torch.float32)
        # divide by a tensor on the leaves' device: CUDA multiplies by the
        # reciprocal of a host scalar, which is not the correctly rounded
        # quotient the CPU and the reference compute
        return (total / total.new_full((), len(leaves))).to(first.dtype)

    return tree.map(_mean, *states)


class ParameterServer:
    """Synchronous parameter-averaging rendezvous for N learner replicas.

    Each replica calls ``sync(replica_id, state)`` after ``average_period``
    local SGD steps; the call blocks until all N replicas of the current
    round have contributed, then every caller receives the same merged
    state.  ``stop()`` wakes blocked callers with ``None`` (the replica
    keeps its own state and exits) — a dead or stopping replica can never
    wedge the others in a half-filled round forever only because fail-fast
    stop reaches this object like any other node instance.

    Quorum mode (``barrier_timeout_s`` + ``min_quorum``) relaxes the
    all-or-nothing barrier for elastic fleets: once a round's first
    contribution is ``barrier_timeout_s`` old, any waiter merges the >=
    ``min_quorum`` states that DID arrive, so a straggling, killed, or
    restoring replica delays a round by at most the timeout instead of
    stalling training forever.  A late replica that MISSED a merge adopts
    the latest merged state instead of contributing — its state predates
    the blend, so folding it in would merge the same logical round twice
    and drag the fleet back toward stale params (counted in
    ``stale_adoptions``).  ``invalidate(replica_id)`` withdraws a killed
    replica's pending contribution (service failover, ROADMAP slice 7b,
    calls it when it marks a replica down), so a restored replica's stale
    ``replica_id`` can never double-contribute to one round; its parked
    ``sync`` returns ``None`` without adopting anything over the restored
    state.  Defaults leave the strict all-or-nothing barrier.
    """

    def __init__(self, num_replicas: int, average_period: int,
                 barrier_timeout_s: Optional[float] = None,
                 min_quorum: Optional[int] = None):
        if num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {num_replicas}")
        if average_period < 1:
            raise ValueError(
                f"average_period must be >= 1, got {average_period}")
        if barrier_timeout_s is not None and barrier_timeout_s <= 0:
            raise ValueError(f"barrier_timeout_s must be > 0, "
                             f"got {barrier_timeout_s}")
        if min_quorum is not None:
            if barrier_timeout_s is None:
                raise ValueError(
                    "min_quorum without barrier_timeout_s is meaningless: "
                    "a round only closes early when the barrier can time "
                    "out")
            if not 1 <= min_quorum <= num_replicas:
                raise ValueError(
                    f"min_quorum must be in [1, {num_replicas}], "
                    f"got {min_quorum}")
        self.num_replicas = num_replicas
        self.average_period = average_period
        # Quorum mode (both None by default — the all-or-nothing barrier is
        # unchanged): a round's deadline starts at its FIRST contribution;
        # past the deadline, any waiter holding >= min_quorum contributions
        # merges what arrived instead of stalling on stragglers.  Late or
        # restored replicas adopt the latest merged state on their next
        # sync rather than deadlocking the round.
        self.barrier_timeout_s = barrier_timeout_s
        self.min_quorum = (min_quorum if min_quorum is not None
                           else (1 if barrier_timeout_s is not None
                                 else None))
        self._cond = threading.Condition()
        self._pending: Dict[int, Any] = {}
        self._merged: Any = None
        self._rounds = 0
        self._quorum_merges = 0
        self._stale_adoptions = 0
        self._round_deadline: Optional[float] = None
        self._stopped = False
        # Per-replica bookkeeping for the quorum fix: the round count each
        # replica last observed (a replica that missed a merge adopts
        # rather than contributes) and an invalidation epoch bumped by
        # ``invalidate`` so a parked sync can be withdrawn.
        self._last_seen: Dict[int, int] = {}
        self._epoch: Dict[int, int] = {}
        # Lazy per-replica barrier-wait histograms: replicas first call
        # ``sync`` from their own worker threads/processes, well after the
        # run entrypoint configured telemetry.
        self._m_barrier: Dict[int, Any] = {}
        self._m_timeouts = None
        _telemetry.probe("learner/param_server", self.stats)

    @property
    def merged(self):
        """Last merged state (None before the first completed round)."""
        with self._cond:
            return self._merged

    @property
    def rounds(self) -> int:
        with self._cond:
            return self._rounds

    @property
    def stopped(self) -> bool:
        with self._cond:
            return self._stopped

    def merge(self, states: Sequence[Any]):
        """Average ``states`` and record the result as a completed round
        (the sequential single-process path, where one thread holds every
        replica and no barrier is needed)."""
        merged = average_states(states)
        with self._cond:
            self._merged = merged
            self._rounds += 1
        return merged

    def sync(self, replica_id: int, state):
        """Contribute ``state`` for the current round; block until all
        replicas have contributed; return the merged state (None once
        stopped)."""
        if not 0 <= replica_id < self.num_replicas:
            raise ValueError(
                f"replica_id must be in [0, {self.num_replicas}), "
                f"got {replica_id}")
        metric = self._m_barrier.get(replica_id)
        if metric is None and _telemetry.enabled():
            metric = self._m_barrier[replica_id] = _telemetry.histogram(
                f"learner/param_server/replica_{replica_id}/barrier_wait_ms")
        t0 = time.monotonic() if metric else 0.0
        result = self._sync(replica_id, state)
        if metric:
            metric.observe((time.monotonic() - t0) * 1000.0)
        return result

    def _sync(self, replica_id: int, state):
        with self._cond:
            if self._stopped:
                return None
            missed_merge = (self._merged is not None
                            and self._rounds
                            > self._last_seen.get(replica_id, 0))
            if self.barrier_timeout_s is not None and missed_merge:
                # Quorum fix: this replica missed a merge — its state was
                # computed from pre-merge params, so contributing it would
                # merge the same logical round a second time (and a lone
                # straggler would then REPLACE the blend with stale
                # params).  Adopt the latest blend instead; it contributes
                # fresh work next period.
                self._stale_adoptions += 1
                self._last_seen[replica_id] = self._rounds
                return self._merged
            round_at_entry = self._rounds
            epoch_at_entry = self._epoch.get(replica_id, 0)
            self._pending[replica_id] = state
            if self.barrier_timeout_s is not None \
                    and self._round_deadline is None:
                self._round_deadline = (time.monotonic()
                                        + self.barrier_timeout_s)
            if len(self._pending) == self.num_replicas:
                self._last_seen[replica_id] = self._rounds + 1
                return self._merge_pending_locked()
            while self._rounds == round_at_entry and not self._stopped \
                    and self._epoch.get(replica_id, 0) == epoch_at_entry:
                if self._quorum_due_locked():
                    self._last_seen[replica_id] = self._rounds + 1
                    return self._merge_pending_locked(timed_out=True)
                self._cond.wait(0.05)
            if self._epoch.get(replica_id, 0) != epoch_at_entry:
                # withdrawn by invalidate(): the caller keeps (or was just
                # restored to) its own state; nothing is adopted.
                return None
            if self._rounds == round_at_entry:   # woken by stop()
                return None
            self._last_seen[replica_id] = self._rounds
            return self._merged

    def invalidate(self, replica_id: int):
        """Withdraw ``replica_id``'s pending contribution (if any) and
        release its parked ``sync`` with ``None`` — called when the replica
        is killed/restored mid-round, so its stale pre-kill state cannot be
        folded into a round it no longer stands behind."""
        with self._cond:
            self._pending.pop(replica_id, None)
            self._epoch[replica_id] = self._epoch.get(replica_id, 0) + 1
            if not self._pending:
                # an empty round has no first contribution: the next one
                # must start a fresh deadline, not inherit a stale one
                self._round_deadline = None
            self._cond.notify_all()

    def _quorum_due_locked(self):
        """True when the round's deadline has passed with >= min_quorum
        contributions — the waiter that observes this performs the merge."""
        return (self._round_deadline is not None
                and time.monotonic() >= self._round_deadline
                and len(self._pending) >= self.min_quorum)

    def _merge_pending_locked(self, timed_out: bool = False):
        merged = average_states(
            [self._pending[i] for i in sorted(self._pending)])
        self._pending.clear()
        self._round_deadline = None
        self._merged = merged
        self._rounds += 1
        if timed_out:
            self._quorum_merges += 1
            if self._m_timeouts is None and _telemetry.enabled():
                self._m_timeouts = _telemetry.counter(
                    "learner/param_server/barrier_timeouts")
            if self._m_timeouts:
                self._m_timeouts.inc()
        self._cond.notify_all()
        return merged

    def stop(self):
        with self._cond:
            self._stopped = True
            self._pending.clear()
            self._round_deadline = None
            self._cond.notify_all()

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            stats = {"num_replicas": self.num_replicas,
                     "average_period": self.average_period,
                     "rounds": self._rounds}
            if self.barrier_timeout_s is not None:
                stats["barrier_timeout_s"] = self.barrier_timeout_s
                stats["min_quorum"] = self.min_quorum
                stats["quorum_merges"] = self._quorum_merges
                stats["stale_adoptions"] = self._stale_adoptions
            return stats


class MultiLearner:
    """N learner replicas behind the single-learner surface.

    Single-process runs step it directly: ``step()`` advances one replica
    per call in round-robin order and averages all replicas in-line once
    every replica has taken ``average_period`` steps since the last merge —
    the sequential equivalent of the distributed barrier.  Distributed runs
    never call ``step()``; replica nodes step themselves and rendezvous at
    the shared ``ParameterServer``, while this facade serves the merged
    view to actors (``get_variables``) and checkpoints (``state``).
    """

    def __init__(self, replicas: Sequence[Any], average_period: int = 50,
                 param_server: Optional[ParameterServer] = None,
                 workers: Optional[Sequence["LearnerReplicaWorker"]] = None):
        self._replicas = list(replicas)
        if not self._replicas:
            raise ValueError("MultiLearner needs at least one replica")
        if average_period < 1:
            raise ValueError(
                f"average_period must be >= 1, got {average_period}")
        self._period = average_period
        self._server = param_server or ParameterServer(
            len(self._replicas), average_period)
        self._workers = list(workers) if workers is not None else None
        self._step_counts = [0] * len(self._replicas)
        self._cursor = 0

    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    @property
    def average_period(self) -> int:
        return self._period

    @property
    def replicas(self) -> List[Any]:
        return list(self._replicas)

    @property
    def param_server(self) -> ParameterServer:
        """The barrier/quorum rendezvous."""
        return self._server

    @property
    def next_replica(self) -> int:
        """Index of the replica the next sequential ``step()`` will
        advance — what a lockstep scheduler must gate on (the step samples
        that replica's shard only, not the aggregate table)."""
        return self._cursor

    # ------------------------------------------------------- learner surface
    def step(self) -> Dict[str, Any]:
        """Sequential round-robin: one replica step per call, and an in-line
        merge once every replica has taken ``average_period`` steps (a full
        cycle of ``num_replicas * average_period`` calls) that every
        replica adopts."""
        i = self._cursor
        metrics = self._replicas[i].step()
        self._step_counts[i] += 1
        self._cursor = (i + 1) % len(self._replicas)
        if self._cursor == 0 and self._step_counts[-1] % self._period == 0:
            merged = self._server.merge([r.state for r in self._replicas])
            for replica in self._replicas:
                replica.state = merged
        return metrics

    def get_variables(self, names: Sequence[str] = ("policy",)):
        """Actors see ONE logical learner: the merged view of the replicas'
        CURRENT params, as numpy (each replica swaps its immutable state
        atomically, so the average is over consistent snapshots).  Only
        params are averaged here — this is the weight-sync hot path, and the
        optimizer moments/target params of the full ``state`` view would be
        computed just to be discarded.  With one replica this is exactly
        that replica's live params — which is what makes the 1-replica
        configuration serve bit-identical weights to the plain learner."""
        params_per_replica = [getattr(r.state, "params", None)
                              for r in self._replicas]
        if any(p is None for p in params_per_replica):
            return self._replicas[0].get_variables(names)
        params = tree.map(lambda x: x.detach().to("cpu", copy=True).numpy(),
                          average_states(params_per_replica))
        return [params for _ in (names or ("policy",))]

    @property
    def state(self):
        """The merged checkpoint view: the average of every replica's
        current state (identity for one replica)."""
        return average_states([r.state for r in self._replicas])

    @state.setter
    def state(self, merged):
        """Restore: broadcast a (checkpointed) merged state to all
        replicas."""
        for replica in self._replicas:
            replica.state = merged

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """Per-replica executed step counts + averaging rounds — what
        ``result.extras['learners']`` reports."""
        if self._workers is not None:
            per_replica = [w.steps_taken for w in self._workers]
        else:
            per_replica = list(self._step_counts)
        return {"num_replicas": len(self._replicas),
                "average_period": self._period,
                "rounds": self._server.rounds,
                "per_replica_steps": per_replica}


class LearnerReplicaWorker:
    """One learner replica as a program-graph node (a run+serve hybrid like
    the single-learner node): steps SGD on its own shard's dataset until
    stopped, rendezvous at the ``ParameterServer`` every ``average_period``
    steps (``param_server=None`` skips the rendezvous — the plain
    single-learner node is the degenerate case), and serves
    ``get_variables`` for debugging/conformance.

    ``dataset`` (a ``PrefetchingDataset`` when prefetch is enabled) is
    closed on stop and on run-loop exit, so replica teardown cannot leak
    sampler threads across sequential runs in one process.
    ``sync_mode="async"`` raises until the ``AsyncParameterService`` is
    ported.
    """

    def __init__(self, learner, param_server=None, replica_id: int = 0,
                 average_period: int = 1, max_steps: Optional[int] = None,
                 dataset=None, shard=None, sync_mode: str = "barrier"):
        if average_period < 1:
            raise ValueError(
                f"average_period must be >= 1, got {average_period}")
        if sync_mode == "async":
            raise NotImplementedError(
                "LearnerReplicaWorker: learner_sync='async' (the "
                "AsyncParameterService) is not ported yet (ROADMAP slice 7b)")
        if sync_mode != "barrier":
            # quorum is a ParameterServer configuration, not a different
            # call path — the worker only distinguishes sync vs push/pull
            raise ValueError(f"sync_mode must be 'barrier' or 'async', "
                             f"got {sync_mode!r}")
        self.learner = learner
        self.param_server = param_server
        self.replica_id = replica_id
        self.average_period = average_period
        self.max_steps = max_steps
        self.dataset = dataset
        self.shard = shard
        self.sync_mode = sync_mode
        self.steps_taken = 0
        self._stop = threading.Event()

    def run(self):
        local = 0
        try:
            while not self._stop.is_set():
                if self.max_steps is not None \
                        and self.steps_taken >= self.max_steps:
                    return
                try:
                    self.learner.step()
                except Exception:
                    if self._stop.is_set():
                        return
                    raise
                self.steps_taken += 1
                local += 1
                if self.param_server is not None \
                        and local >= self.average_period:
                    local = 0
                    merged = self.param_server.sync(self.replica_id,
                                                    self.learner.state)
                    if merged is None:
                        if getattr(self.param_server, "stopped", False):
                            return   # server stopped mid-round
                        # withdrawn (invalidate): keep local state
                        continue
                    self.learner.state = merged
        finally:
            self._close_dataset()

    def stop(self):
        self._stop.set()
        # wake a step() blocked on the prefetch queue: close() sets the
        # dataset's stop event, its next() raises the "stopped" timeout,
        # and the run loop exits through the stop check above.
        self._close_dataset()

    def get_variables(self, names: Sequence[str] = ()):
        return self.learner.get_variables(names)

    def _close_dataset(self):
        if self.dataset is not None and hasattr(self.dataset, "close"):
            self.dataset.close()
