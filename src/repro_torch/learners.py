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
- ``AsyncParameterService`` — the barrier-free alternative: a key-value
  ``push(replica_id, state, step)`` / ``pull()`` service with
  staleness-weighted merging (``weighted_average_states``), so each
  replica pushes at its own cadence and pulls the latest blend without
  ever waiting for peers.  Selected via ``learner_sync="async"``; the
  barrier/quorum ``ParameterServer`` stays the default.

Replicas and the parameter services are parent-resident services, so
merged states stay tensors on the learners' device and never cross
courier.  Replicas and the async service snapshot and restore for service
failover (``state_dict``/``load_state_dict``, ``mark_down``/``mark_up``);
their snapshots copy each state's tensors to the host once
(``repro_torch.resilience.failover.HostTree``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.resilience.failover import HostTree
from repro_torch.telemetry import registry as _telemetry

# The declared RPC surface of the parameter-server node (what a multi-host
# backend would let remote replicas call).
PARAM_SERVER_INTERFACE = ("sync", "stats")

# The async service's surface: pushes and pulls never block on peers, so
# there is no rendezvous call to expose.
ASYNC_PARAM_SERVICE_INTERFACE = ("push", "pull", "stats")

# Staleness-weighted merge modes of the AsyncParameterService.
ASYNC_MERGE_MODES = ("mean", "ema", "step_weighted")

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


def weighted_average_states(states: Sequence[Any],
                            weights: Sequence[float]):
    """Element-wise WEIGHTED mean over identically-structured trees — the
    staleness-weighted generalization of ``average_states``, on the
    tensors' own device.

    Float leaves accumulate ``leaf * w`` in float32 under normalized
    weights and cast back to their dtype: each weight is normalized in
    float64 on the host, becomes a float32 tensor on the leaf's device, and
    each replica adds one float32 multiply and one add in replica order —
    the JAX package's arithmetic, so the result is the same bits on any
    device.  Integer leaves (step counters) keep the floor-mean contract:
    when every state agrees on a counter the result is that exact value at
    ANY magnitude (no float round-trip); disagreeing counters take the
    weighted floor mean in float64.  The counters are read back in one
    copy for the whole tree.  A single-state average is the identity
    regardless of its weight — which is what makes a 1-replica async blend
    bit-equivalent to the plain learner.
    """
    states = list(states)
    weights = [float(w) for w in weights]
    if not states:
        raise ValueError("weighted_average_states needs at least one state")
    if len(states) != len(weights):
        raise ValueError(
            f"got {len(states)} states but {len(weights)} weights")
    if any(w < 0.0 for w in weights) or sum(weights) <= 0.0:
        raise ValueError(
            f"weights must be non-negative with a positive sum, "
            f"got {weights}")
    if len(states) == 1:
        return states[0]
    total_w = sum(weights)
    norm = [w / total_w for w in weights]
    tree.map(lambda *_: None, *states)     # the structures must agree
    treedef = tree.flatten(states[0])[1]
    columns = list(zip(*(tree.leaves(state) for state in states)))
    firsts = [torch.as_tensor(column[0]) for column in columns]
    merged: List[Any] = [None] * len(columns)
    counters = [i for i, first in enumerate(firsts)
                if not (first.is_floating_point()
                        or first.dtype == torch.bool)]
    if counters:
        # every replica's counters of the whole tree, in one copy
        host = torch.cat([
            torch.as_tensor(leaf, device=firsts[i].device)
            .reshape(-1).to(torch.int64)
            for i in counters for leaf in columns[i]]).cpu().numpy()
        offset = 0
        for i in counters:
            first, size = firsts[i], firsts[i].numel()
            arrs = [host[offset + r * size:offset + (r + 1) * size]
                    for r in range(len(states))]
            offset += size * len(states)
            if all(np.array_equal(arrs[0], a) for a in arrs[1:]):
                # agreement is exact at any magnitude — no float round-trip
                out = arrs[0]
            else:
                total = sum(w * a.astype(np.float64)
                            for w, a in zip(norm, arrs))
                out = np.floor(total).astype(np.int64)
            merged[i] = torch.from_numpy(out.reshape(first.shape)).to(
                device=first.device, dtype=first.dtype)
    scales = {}      # device -> the normalized weights, float32, there
    for i, (column, first) in enumerate(zip(columns, firsts)):
        if merged[i] is not None:
            continue
        scale = scales.get(first.device)
        if scale is None:
            scale = scales[first.device] = torch.tensor(
                norm, dtype=torch.float32).to(first.device)
        total = None
        for r, leaf in enumerate(column):
            term = torch.as_tensor(leaf, device=first.device).to(
                torch.float32) * scale[r]
            total = term if total is None else total + term
        merged[i] = total.to(first.dtype)
    return tree.unflatten(treedef, merged)


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
    replica's pending contribution (the failover path calls it from
    ``LearnerReplicaWorker.mark_down``), so a restored replica's stale
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


class AsyncParameterService:
    """Barrier-free parameter exchange: push at your own cadence, pull the
    latest staleness-weighted blend, never wait for a peer.

    Each replica calls ``push(replica_id, state, step)`` after its local
    averaging period (``step`` is its cumulative SGD step count) and then
    ``pull()``s the current blend — both calls return immediately, so one
    slow replica can no longer stall the fleet (the ``learner_sync="async"``
    mode of ROADMAP open item 1).  The blend over the current per-replica
    contributions is recomputed lazily at pull time, only when a push
    changed something:

    - ``merge="mean"``: uniform weights — ``average_states`` semantics.
    - ``merge="ema"`` (default): weight ``ema_alpha ** age`` where ``age =
      max_step - step`` is the contribution's staleness in learner steps —
      stale replicas decay exponentially out of the blend.
    - ``merge="step_weighted"``: weight ``1 + step`` — contributions count
      in proportion to how much training they embody.

    A single contribution is returned VERBATIM (``weighted_average_states``
    identity), so 1-replica async training is bit-equivalent to the plain
    learner.  ``staleness_bound`` drops contributions older than the bound
    from the blend entirely (the freshest contribution always survives).

    Contributions stay trees of tensors on the learners' device, and so does
    the blend.  The service is ``Recoverable`` (``state_dict``/
    ``load_state_dict``; a snapshot copies each contribution to the host in
    one transfer, and a restore puts it back on its device) and supports
    simulated death (``mark_down`` makes push/pull raise
    ``ServiceUnavailable`` until ``mark_up``), so the ``ServiceWatchdog``
    snapshots and restores it at the same courier address like any other
    service; replicas degrade (skip the exchange) through the restart
    window instead of dying.
    """

    def __init__(self, num_replicas: int, merge: str = "ema",
                 ema_alpha: float = 0.5,
                 staleness_bound: Optional[int] = None):
        if num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {num_replicas}")
        if merge not in ASYNC_MERGE_MODES:
            raise ValueError(f"merge must be one of {ASYNC_MERGE_MODES}, "
                             f"got {merge!r}")
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], got {ema_alpha}")
        if staleness_bound is not None and staleness_bound < 1:
            raise ValueError(f"staleness_bound must be >= 1, "
                             f"got {staleness_bound}")
        self.num_replicas = num_replicas
        self.merge = merge
        self.ema_alpha = float(ema_alpha)
        self.staleness_bound = staleness_bound
        self._lock = threading.Lock()
        # replica_id -> (state, step): the latest push per replica.
        self._contrib: Dict[int, Any] = {}
        self._max_step = 0
        self._blend = None
        self._blend_age = 0
        self._dirty = False
        self._pushes = 0
        self._pulls = 0
        self._merges = 0
        self._dropped_stale = 0
        self._stopped = False
        self._down = threading.Event()
        # Lazy histograms: replicas push from their own threads/processes,
        # well after the run entrypoint configured telemetry.
        self._m_push_staleness = None
        self._m_pull_age = None
        _telemetry.probe("learner/param_service", self.stats)

    # ------------------------------------------------------------- data path
    def push(self, replica_id: int, state, step: int):
        """Record ``replica_id``'s state at cumulative SGD step ``step``;
        returns immediately (no rendezvous)."""
        if not 0 <= replica_id < self.num_replicas:
            raise ValueError(
                f"replica_id must be in [0, {self.num_replicas}), "
                f"got {replica_id}")
        step = int(step)
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        self._check_up()
        with self._lock:
            if self._stopped:
                return
            staleness = max(self._max_step - step, 0)
            self._contrib[replica_id] = (state, step)
            self._max_step = max(self._max_step, step)
            self._pushes += 1
            self._dirty = True
        if self._m_push_staleness is None and _telemetry.enabled():
            self._m_push_staleness = _telemetry.histogram(
                "learner/push_staleness")
        if self._m_push_staleness:
            self._m_push_staleness.observe(staleness)

    def pull(self):
        """The latest blend over the current contributions (recomputed only
        when a push changed something); ``None`` before the first push or
        once stopped."""
        self._check_up()
        with self._lock:
            if self._stopped:
                return None
            self._pulls += 1
            if not self._contrib:
                return None
            if self._dirty:
                self._recompute_locked()
            blend, age = self._blend, self._blend_age
        if self._m_pull_age is None and _telemetry.enabled():
            self._m_pull_age = _telemetry.histogram("learner/pull_age_steps")
        if self._m_pull_age:
            self._m_pull_age.observe(age)
        return blend

    def _recompute_locked(self):
        entries = sorted(self._contrib.items())
        kept = entries
        if self.staleness_bound is not None:
            kept = [(rid, (state, step)) for rid, (state, step) in entries
                    if self._max_step - step <= self.staleness_bound]
            self._dropped_stale += len(entries) - len(kept)
            if not kept:   # never blend nothing: keep the freshest
                kept = [max(entries, key=lambda e: e[1][1])]
        states = [state for _, (state, _) in kept]
        ages = [self._max_step - step for _, (_, step) in kept]
        if len(states) == 1:
            # verbatim — the 1-replica parity guarantee
            self._blend = states[0]
        elif self.merge == "mean":
            self._blend = average_states(states)
        elif self.merge == "ema":
            weights = [self.ema_alpha ** age for age in ages]
            self._blend = weighted_average_states(states, weights)
        else:   # step_weighted
            weights = [1.0 + step for _, (_, step) in kept]
            self._blend = weighted_average_states(states, weights)
        self._blend_age = max(ages)
        self._merges += 1
        self._dirty = False

    def invalidate(self, replica_id: int):
        """Drop ``replica_id``'s contribution from future blends — called
        when the replica is killed, so a restored replica's stale pre-kill
        state stops weighing on the fleet."""
        with self._lock:
            if self._contrib.pop(replica_id, None) is not None:
                self._dirty = True

    # ------------------------------------------------------------ lifecycle
    @property
    def rounds(self) -> int:
        """Blend recomputations so far (the async analogue of the barrier
        server's averaging rounds)."""
        with self._lock:
            return self._merges

    @property
    def stopped(self) -> bool:
        with self._lock:
            return self._stopped

    def stop(self):
        with self._lock:
            self._stopped = True

    # --------------------------------------------------- service failover
    def mark_down(self):
        """Simulate abrupt service death: push/pull raise
        ``ServiceUnavailable`` until ``mark_up`` (replicas degrade — skip
        the exchange and keep training on local state).  Metadata reads
        (``stats``/``state_dict``) stay available for the watchdog."""
        self._down.set()

    def mark_up(self):
        self._down.clear()

    def _check_up(self):
        if self._down.is_set():
            from repro_torch.distributed.courier import ServiceUnavailable
            raise ServiceUnavailable(
                "async parameter service is down (simulated failure; "
                "awaiting failover)")

    def activity(self) -> int:
        """Monotonic progress counter for chaos kill triggers."""
        with self._lock:
            return self._pushes + self._pulls

    def state_dict(self) -> Dict[str, Any]:
        """Snapshot for service failover: contributions (replicas swap
        their state trees atomically, so concurrent reads are consistent),
        the step high-water mark, and the counters.  Each contribution is
        copied to the host as one ``HostTree``, outside the lock, so pushes
        and pulls do not wait for the device."""
        with self._lock:
            state = {"contrib": dict(self._contrib),
                     "max_step": self._max_step,
                     "pushes": self._pushes,
                     "pulls": self._pulls,
                     "merges": self._merges,
                     "dropped_stale": self._dropped_stale}
        state["contrib"] = {rid: (HostTree(contrib), step)
                            for rid, (contrib, step)
                            in state["contrib"].items()}
        return state

    def load_state_dict(self, state: Dict[str, Any]):
        """Restore a snapshot: every contribution's leaves back on the
        device and in the dtype they were pushed with."""
        contrib = {rid: (c.restore() if isinstance(c, HostTree) else c, step)
                   for rid, (c, step) in state["contrib"].items()}
        with self._lock:
            self._contrib = contrib
            self._max_step = int(state["max_step"])
            self._pushes = int(state["pushes"])
            self._pulls = int(state["pulls"])
            self._merges = int(state["merges"])
            self._dropped_stale = int(state.get("dropped_stale", 0))
            self._blend = None
            self._blend_age = 0
            self._dirty = True   # recompute from restored contributions

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            stats = {"num_replicas": self.num_replicas,
                     "merge": self.merge,
                     "pushes": self._pushes,
                     "pulls": self._pulls,
                     "merges": self._merges,
                     "contributors": len(self._contrib),
                     "max_step": self._max_step}
            if self.staleness_bound is not None:
                stats["staleness_bound"] = self.staleness_bound
                stats["dropped_stale"] = self._dropped_stale
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
                 workers: Optional[Sequence["LearnerReplicaWorker"]] = None,
                 async_service: Optional[AsyncParameterService] = None):
        self._replicas = list(replicas)
        if not self._replicas:
            raise ValueError("MultiLearner needs at least one replica")
        if average_period < 1:
            raise ValueError(
                f"average_period must be >= 1, got {average_period}")
        if async_service is not None and param_server is not None:
            raise ValueError(
                "pass either param_server (barrier/quorum) or "
                "async_service (learner_sync='async'), not both")
        self._period = average_period
        self._async = async_service
        self._server = param_server if async_service is not None else (
            param_server or ParameterServer(
                len(self._replicas), average_period))
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
    def param_server(self) -> Optional[ParameterServer]:
        """The barrier/quorum rendezvous (None in async mode)."""
        return self._server

    @property
    def async_service(self) -> Optional[AsyncParameterService]:
        """The push/pull service (None in barrier/quorum mode)."""
        return self._async

    @property
    def next_replica(self) -> int:
        """Index of the replica the next sequential ``step()`` will
        advance — what a lockstep scheduler must gate on (the step samples
        that replica's shard only, not the aggregate table)."""
        return self._cursor

    # ------------------------------------------------------- learner surface
    def step(self) -> Dict[str, Any]:
        """Sequential round-robin: one replica step per call.  Barrier mode
        merges in-line once every replica has taken ``average_period`` steps
        (a full cycle of ``num_replicas * average_period`` calls) and every
        replica adopts the merge.  Async mode has no fleet-wide rendezvous:
        each replica pushes/pulls at ITS OWN period boundary and adopts the
        current blend — with one replica the blend is its own state
        verbatim, so the schedule is bit-identical to the plain learner."""
        i = self._cursor
        metrics = self._replicas[i].step()
        self._step_counts[i] += 1
        self._cursor = (i + 1) % len(self._replicas)
        if self._async is not None:
            if self._step_counts[i] % self._period == 0:
                self._async.push(i, self._replicas[i].state,
                                 self._step_counts[i])
                blend = self._async.pull()
                if blend is not None:
                    self._replicas[i].state = blend
        elif self._cursor == 0 \
                and self._step_counts[-1] % self._period == 0:
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
        stats = {"num_replicas": len(self._replicas),
                 "average_period": self._period,
                 "rounds": (self._async.rounds if self._async is not None
                            else self._server.rounds),
                 "per_replica_steps": per_replica}
        if self._async is not None:
            stats["sync"] = "async"
            stats["service"] = self._async.stats()
        return stats


class LearnerReplicaWorker:
    """One learner replica as a program-graph node (a run+serve hybrid like
    the single-learner node): steps SGD on its own shard's dataset until
    stopped, rendezvous at the ``ParameterServer`` every ``average_period``
    steps — or, with ``sync_mode="async"``, pushes its state to the
    ``AsyncParameterService`` and pulls the blend (``param_server=None``
    skips the exchange — the plain single-learner node is the degenerate
    case), and serves ``get_variables`` for debugging/conformance.

    ``dataset`` (a ``PrefetchingDataset`` when prefetch is enabled) is
    closed on stop and on run-loop exit, so replica teardown cannot leak
    sampler threads across sequential runs in one process.

    For service failover a replica is recoverable and can simulate death:
    ``mark_down`` pauses the run loop and withdraws the replica's parked
    contribution, ``state_dict``/``load_state_dict`` snapshot and restore
    the learner's state (one host copy of its tensors, ``HostTree``;
    restored onto the device and dtype they came from), and ``mark_up``
    resumes it.  A pass of the run loop (a step and its exchange) and a
    restore take turns, so a step in flight at a kill cannot overwrite the
    state restored after it.  An unreachable replay shard or parameter
    service costs a skipped step or exchange (counted), not the replica.
    """

    def __init__(self, learner, param_server=None, replica_id: int = 0,
                 average_period: int = 1, max_steps: Optional[int] = None,
                 dataset=None, shard=None, sync_mode: str = "barrier"):
        if average_period < 1:
            raise ValueError(
                f"average_period must be >= 1, got {average_period}")
        if sync_mode not in ("barrier", "async"):
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
        self._local = 0     # steps since the last exchange
        self._stop = threading.Event()
        self._down = threading.Event()
        self._turn = threading.Lock()   # one run-loop pass, or a restore
        self._m_degraded = None

    def run(self):
        try:
            while not self._stop.is_set():
                if self._down.is_set():
                    # simulated death (service failover): pause until the
                    # watchdog restores this replica's state and marks it up
                    time.sleep(0.02)
                    continue
                if self.max_steps is not None \
                        and self.steps_taken >= self.max_steps:
                    return
                with self._turn:
                    if not self._down.is_set() and not self._pass():
                        return
        finally:
            self._close_dataset()

    def _pass(self) -> bool:
        """One SGD step and, at a period boundary, the exchange; False once
        the run loop should end."""
        try:
            self.learner.step()
        except ConnectionError:
            if self._stop.is_set():
                return False
            # this replica's replay shard is in its restart window: degrade
            # (skip the step) instead of dying and burning a restart budget
            # that belongs to real failures
            self._degraded_metric_inc()
            time.sleep(0.05)
            return True
        except Exception:
            if self._stop.is_set():
                return False
            raise
        self.steps_taken += 1
        self._local += 1
        if self.param_server is None or self._local < self.average_period:
            return True
        self._local = 0
        try:
            if self.sync_mode == "async":
                # push-then-pull, never waiting on peers: one slow replica
                # costs the blend staleness, not fleet throughput
                self.param_server.push(self.replica_id, self.learner.state,
                                       self.steps_taken)
                merged = self.param_server.pull()
            else:
                merged = self.param_server.sync(self.replica_id,
                                                self.learner.state)
        except ConnectionError:
            if self._stop.is_set():
                return False
            self._degraded_metric_inc()
            return True     # keep local state; rejoin next period
        if merged is None:
            # the server stopped mid-round, or the contribution was
            # withdrawn (invalidate during failover) or nothing was pushed
            # yet: keep local state; the down-check pauses a dead replica
            return not getattr(self.param_server, "stopped", False)
        self.learner.state = merged
        return True

    def stop(self):
        self._stop.set()
        # wake a step() blocked on the prefetch queue: close() sets the
        # dataset's stop event, its next() raises the "stopped" timeout,
        # and the run loop exits through the stop check above.
        self._close_dataset()

    # --------------------------------------------------- service failover
    def mark_down(self):
        """Simulate abrupt replica death: the run loop pauses (no SGD, no
        rendezvous — with quorum averaging the other replicas keep merging
        without it) until the watchdog restores and ``mark_up``s it.  Any
        contribution parked at the parameter server is withdrawn — a dead
        replica's stale state must not be folded into a round (and the
        restored state must not be overwritten by a merge it predates)."""
        self._down.set()
        invalidate = getattr(self.param_server, "invalidate", None)
        if callable(invalidate):
            try:
                invalidate(self.replica_id)
            except ConnectionError:
                pass   # the service itself is down; nothing parked survives

    def mark_up(self):
        self._down.clear()

    def state_dict(self) -> Dict[str, Any]:
        """Snapshot for service failover: the learner's state (replicas
        swap it atomically, so a concurrent read is a consistent state),
        its tensors copied to the host in one transfer, plus the step count
        the restart accounting resumes from."""
        steps = self.steps_taken     # first: the state is at least as new
        return {"learner_state": HostTree(self.learner.state),
                "steps_taken": steps}

    def load_state_dict(self, state: Dict[str, Any]):
        """Restore a snapshot once any run-loop pass in flight has ended,
        every leaf back on its device and in its dtype."""
        learner_state = state["learner_state"]
        if isinstance(learner_state, HostTree):
            learner_state = learner_state.restore()
        with self._turn:
            self.learner.state = learner_state
            self.steps_taken = int(state["steps_taken"])

    def _degraded_metric_inc(self):
        if self._m_degraded is None:
            if not _telemetry.enabled():
                return
            self._m_degraded = _telemetry.counter(
                f"resilience/learner_replica_{self.replica_id}/skipped_steps")
        self._m_degraded.inc()

    def get_variables(self, names: Sequence[str] = ()):
        return self.learner.get_variables(names)

    def _close_dataset(self):
        if self.dataset is not None and hasattr(self.dataset, "close"):
            self.dataset.close()
