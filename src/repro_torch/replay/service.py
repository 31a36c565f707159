"""Sharded replay service (§2.4–§2.5 scaled out).

The paper's scaling story is that replay is a *service*: actors and learners
scale independently because they only ever talk to a rate-limited storage
layer.  A single ``Table`` serializes every insert, sample, and priority
update through one lock and one condition variable — the bottleneck every
distributed run funnels through.  ``ShardedReplay`` horizontally shards that
service: N full tables (each with its own selector and ``RateLimiter``),
constructed from the *same* ``builder.make_replay()`` factory so every
registered builder works unchanged.

Design:

- **Insert routing** — round-robin (default), a multiplicative hash of the
  insert ticket, or *affinity*: writers hold a ``ShardWriter`` view of one
  shard and insert shard-directly, bypassing the front-end's routing cursor
  entirely (per-env adder streams land on assigned shards, so the
  actor→replay→learner pipeline is shard-parallel end to end with no
  cross-shard coordination).  All modes keep shards balanced so
  per-shard ``min_size_to_sample`` thresholds are reached together; under
  affinity the balance comes from the env→shard assignment being a
  round-robin of the fleet's global env ids.
- **Shard-id-encoded keys** — the global key of an item stored in shard ``i``
  with local key ``k`` is ``k * num_shards + i``; ``update_priorities`` can
  therefore route each key back to its owning shard without any lookup table.
- **Interleaved sampling** — a batch is drawn one item at a time from the
  shards in rotating round-robin order, i.e. the sampling distribution is a
  uniform mixture over shards; reported probabilities are scaled by
  ``1/num_shards`` accordingly.
- **Per-shard rate limiting** — each shard keeps its own ``RateLimiter``, so
  the §2.5 SPI invariant holds *per shard* (and thus in aggregate); the
  ``rate_limiter`` property is an aggregated read view whose ``inserts`` /
  ``samples`` / ``min_size_to_sample`` sum across shards.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.replay.table import Item, Table

# The declared RPC surface of a replay service node (shard or front-end):
# what a courier server wrapping it lets remote adders/learners call.  The
# distributed assembly layer attaches this to every replay node it emits, so
# each shard is independently courier-addressable (the seam a multi-host
# backend will use to place shards on remote replay servers).
REPLAY_INTERFACE = ("insert", "sample", "update_priorities", "size", "stats")

# Knuth's multiplicative hash constant: decorrelates consecutive tickets.
_HASH_MULT = 2654435761

# Insert-routing modes ShardedReplay accepts.  "affinity" means writers
# route themselves through ShardWriter views; the front-end falls back to
# round-robin for any insert that still reaches it directly.
ROUTING_MODES = ("round_robin", "hash", "affinity")


class ShardWriter:
    """Client-side single-shard view with global-key encoding.

    Wraps one shard (an in-memory ``Table`` or a courier handle to a
    ``replay/shard_i`` node — the call syntax is identical) and speaks the
    insert/priority surface adders and learners use, translating between
    the shard's LOCAL keys and the sharded service's GLOBAL keys
    (``global = local * num_shards + shard_idx``).  This is what gives
    per-env adders shard affinity: each env's adder writes straight to its
    assigned shard with zero front-end coordination, while the keys it
    observes stay interchangeable with the front-end's — priority updates
    route back to the owning shard through the same encoding.

    Picklable whenever the wrapped shard reference is (courier handles
    degrade to ``RemoteHandle`` stubs), so vectorized actor workers carry
    their writers across process boundaries.
    """

    def __init__(self, shard, shard_idx: int, num_shards: int):
        if not 0 <= shard_idx < num_shards:
            raise ValueError(
                f"shard_idx must be in [0, {num_shards}), got {shard_idx}")
        self.shard = shard
        self.shard_idx = shard_idx
        self.num_shards = num_shards
        self._m_inserts = None

    def insert(self, data, priority: float = 1.0,
               timeout: Optional[float] = None) -> int:
        local_key = self.shard.insert(data, priority, timeout=timeout)
        from repro_torch.telemetry import registry as _telemetry
        if self._m_inserts is None and _telemetry.enabled():
            self._m_inserts = _telemetry.counter(
                f"replay/routing/shard_{self.shard_idx}/inserts")
        if self._m_inserts:
            self._m_inserts.inc()
        return local_key * self.num_shards + self.shard_idx

    def update_priorities(self, keys: Sequence[int],
                          priorities: Sequence[float]):
        """Global-key priority updates for items owned by THIS shard (keys
        owned by other shards are a routing bug, not a silent drop)."""
        locals_, ps = [], []
        for key, priority in zip(keys, priorities):
            local, idx = divmod(int(key), self.num_shards)
            if idx != self.shard_idx:
                raise ValueError(
                    f"key {key} belongs to shard {idx}, not this writer's "
                    f"shard {self.shard_idx}")
            locals_.append(local)
            ps.append(priority)
        if locals_:
            self.shard.update_priorities(locals_, ps)

    def size(self) -> int:
        return self.shard.size()

    def __getstate__(self):
        # the lazy metric is process-local (re-created where we land)
        return {"shard": self.shard, "shard_idx": self.shard_idx,
                "num_shards": self.num_shards}

    def __setstate__(self, state):
        self.shard = state["shard"]
        self.shard_idx = state["shard_idx"]
        self.num_shards = state["num_shards"]
        self._m_inserts = None


class _Ticket:
    """Monotonic routing cursor.  itertools.count would be marginally
    cheaper but can't be read or restored, and exact resume needs the
    insert/sample routing position to survive a checkpoint."""

    __slots__ = ("_lock", "_value")

    def __init__(self, start: int = 0):
        self._lock = threading.Lock()
        self._value = int(start)

    def next(self) -> int:
        with self._lock:
            value = self._value
            self._value += 1
            return value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def set(self, value: int):
        with self._lock:
            self._value = int(value)


class AggregateRateLimiter:
    """Read-mostly view over the shards' limiters.

    Quacks like a ``RateLimiter`` for the stats and control surface the
    execution layers use (``inserts``/``samples``/``min_size_to_sample``/
    ``would_block_*``/``stop``); blocking itself stays per shard.
    """

    def __init__(self, shards: Sequence[Table]):
        self._shards = list(shards)

    @property
    def inserts(self) -> int:
        return sum(s.rate_limiter.inserts for s in self._shards)

    @property
    def samples(self) -> int:
        return sum(s.rate_limiter.samples for s in self._shards)

    @property
    def min_size_to_sample(self) -> int:
        return sum(s.rate_limiter.min_size_to_sample for s in self._shards)

    @property
    def stopped(self) -> bool:
        return any(s.rate_limiter.stopped for s in self._shards)

    def would_block_insert(self) -> bool:
        return any(s.rate_limiter.would_block_insert() for s in self._shards)

    def would_block_sample(self) -> bool:
        return any(s.rate_limiter.would_block_sample() for s in self._shards)

    def stop(self):
        for s in self._shards:
            s.rate_limiter.stop()


class ShardedReplay:
    """N replay shards behind the single-table interface.

    Drop-in for ``Table`` everywhere the execution layers touch replay:
    ``insert`` / ``sample`` / ``update_priorities`` / ``size`` / ``stop``,
    plus the ``selector`` / ``rate_limiter`` attributes that
    ``repro_torch.agents.builders`` reads.  Construct via ``from_factory``
    with the builder's own ``make_replay`` so sharding needs no per-agent
    code.
    """

    def __init__(self, shards: Sequence[Table], name: str = "sharded_replay",
                 routing: str = "round_robin"):
        if not shards:
            raise ValueError("ShardedReplay needs at least one shard")
        if routing not in ROUTING_MODES:
            raise ValueError(f"unknown routing {routing!r} "
                             f"(expected one of {ROUTING_MODES})")
        self.name = name
        self.shards: List[Table] = list(shards)
        self.num_shards = len(self.shards)
        self.routing = routing
        self.capacity = sum(s.capacity for s in self.shards)
        self.rate_limiter = AggregateRateLimiter(self.shards)
        self._insert_ticket = _Ticket()
        self._sample_ticket = _Ticket()

    @classmethod
    def from_factory(cls, make_replay: Callable[[], Table], num_shards: int,
                     routing: str = "round_robin") -> "ShardedReplay":
        """Build N shards from a builder's ``make_replay`` factory."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        shards = [make_replay() for _ in range(num_shards)]
        for i, shard in enumerate(shards):
            shard.name = f"{shard.name}/shard_{i}"
            # One factory means identical selector RNG streams; under the
            # lockstep sample rotation that would correlate cross-shard
            # draws (each shard picking the same position each round), so
            # give every shard a distinct deterministic stream.
            rng = getattr(shard.selector, "_rng", None)
            if rng is not None and i:
                rng.seed((i + 1) * _HASH_MULT)
        return cls(shards, name=f"sharded[{num_shards}]", routing=routing)

    # ------------------------------------------------------------ routing
    def _route(self) -> int:
        # "affinity" inserts normally arrive shard-directly via ShardWriter
        # views; anything still reaching the front-end (e.g. a restore
        # replaying transitions) falls back to the round-robin cursor.
        ticket = self._insert_ticket.next()
        if self.routing == "hash":
            return ((ticket * _HASH_MULT) >> 7) % self.num_shards
        return ticket % self.num_shards

    def shard_of(self, global_key: int) -> int:
        return global_key % self.num_shards

    def _global_key(self, local_key: int, shard_idx: int) -> int:
        return local_key * self.num_shards + shard_idx

    def shard_view(self, shard_idx: int) -> ShardWriter:
        """A ``ShardWriter`` over shard ``shard_idx``: shard-direct inserts
        that return GLOBAL keys (the in-memory counterpart of wiring a
        writer to a ``replay/shard_i`` courier handle)."""
        return ShardWriter(self.shards[shard_idx], shard_idx,
                           self.num_shards)

    # ------------------------------------------------------------ table api
    @property
    def selector(self):
        # Shards are homogeneous (one factory); expose shard 0's selector for
        # the ``consumes`` probe the synchronous agent loop performs.
        return self.shards[0].selector

    def insert(self, data, priority: float = 1.0,
               timeout: Optional[float] = None) -> int:
        idx = self._route()
        local_key = self.shards[idx].insert(data, priority, timeout=timeout)
        return self._global_key(local_key, idx)

    def sample(self, batch_size: int = 1,
               timeout: Optional[float] = None) -> List[Tuple[Item, float]]:
        """Interleaved cross-shard sampling: item j of the batch comes from
        shard (cursor + j) % N, each drawn under that shard's own limiter."""
        start = self._sample_ticket.next()
        out: List[Tuple[Item, float]] = []
        for j in range(batch_size):
            idx = (start + j) % self.num_shards
            (item, prob), = self.shards[idx].sample(1, timeout=timeout)
            out.append((Item(self._global_key(item.key, idx), item.data,
                             item.priority), prob / self.num_shards))
        return out

    def update_priorities(self, keys: Sequence[int],
                          priorities: Sequence[float]):
        by_shard: Dict[int, Tuple[List[int], List[float]]] = {}
        for key, priority in zip(keys, priorities):
            local, idx = divmod(int(key), self.num_shards)
            ks, ps = by_shard.setdefault(idx, ([], []))
            ks.append(local)
            ps.append(priority)
        for idx, (ks, ps) in by_shard.items():
            self.shards[idx].update_priorities(ks, ps)

    def size(self) -> int:
        return sum(s.size() for s in self.shards)

    @property
    def stopped(self) -> bool:
        return self.rate_limiter.stopped

    def stop(self):
        for s in self.shards:
            s.stop()

    # ----------------------------------------------------- exact resume
    def state_dict(self) -> Dict:
        """Per-shard table snapshots plus the routing cursors, so resumed
        inserts/samples land on the same shards they would have."""
        return {
            "num_shards": self.num_shards,
            "routing": self.routing,
            "shards": [s.state_dict() for s in self.shards],
            "insert_ticket": self._insert_ticket.value,
            "sample_ticket": self._sample_ticket.value,
        }

    def load_state_dict(self, state: Dict):
        if int(state["num_shards"]) != self.num_shards:
            raise ValueError(
                f"shard count mismatch: checkpoint has "
                f"{state['num_shards']}, service has {self.num_shards}")
        for shard, shard_state in zip(self.shards, state["shards"]):
            shard.load_state_dict(shard_state)
        self._insert_ticket.set(state["insert_ticket"])
        self._sample_ticket.set(state["sample_ticket"])

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict:
        """Aggregated inserts/samples/size plus the per-shard breakdown the
        §2.5 invariant is checked against."""
        per_shard = []
        for s in self.shards:
            rl = s.rate_limiter
            per_shard.append({"name": s.name, "size": s.size(),
                              "inserts": rl.inserts, "samples": rl.samples,
                              "min_size_to_sample": rl.min_size_to_sample})
        return {"num_shards": self.num_shards,
                "size": self.size(),
                "inserts": self.rate_limiter.inserts,
                "samples": self.rate_limiter.samples,
                "per_shard": per_shard}


def make_replay_shards(make_replay: Callable[[], Table], num_shards: int,
                       routing: str = "round_robin"):
    """``num_shards <= 1`` keeps the plain single table (zero overhead);
    otherwise returns a ``ShardedReplay`` over N factory-built shards."""
    if num_shards <= 1:
        return make_replay()
    return ShardedReplay.from_factory(make_replay, num_shards,
                                      routing=routing)
