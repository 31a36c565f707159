"""KV-cache slot pool for continuous-batching policy serving.

One device-resident batched cache (``network.init_cache`` over
``num_slots + 1`` rows) backs every in-flight episode: each episode owns a
SLOT (one batch row) for its lifetime and the server gathers the active
rows, runs one forward pass, and scatters the updated rows back.

The extra row is a SCRATCH slot: batched forward passes are padded to
power-of-two buckets and every pad row gathers/scatters the scratch slot,
so padding never corrupts a live episode's cache.

Slot lifecycle:

- ``acquire(key)``: claim a free slot for episode ``key``; blocks up to
  ``timeout`` (backpressure) and raises ``CacheSlotsExhausted`` after it.
- ``release(key)`` / ``reset_slot(slot)``: recycle on episode end — the
  cache rows are NOT zeroed, position metadata alone invalidates them.
- ``invalidate_all()``: bump the pool generation after a server weight
  refresh; slots with a stale generation are re-prefilled before their
  next decode (stale-cache rejection — K/V computed under old weights
  never mixes with fresh queries).

Churn tolerance: a worker that dies without calling ``release`` would leak
its slots forever.  Every ``lookup``/``acquire`` touches the slot's
last-used clock; when ``acquire`` finds the pool full it first reaps slots
idle for longer than ``reap_idle_s`` — a live episode touches its slot every
policy step, so only dead clients' slots qualify.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from repro_torch.models.config import ArchConfig
from repro_torch.policies import network


class CacheSlotsExhausted(RuntimeError):
    """All cache slots are held by live episodes and none freed in time."""


class _Slot:
    __slots__ = ("index", "key", "pos", "cache_pos", "generation",
                 "last_used")

    def __init__(self, index: int):
        self.index = index
        self.key = None
        self.pos = -1             # last EPISODE step absorbed into the slot
        self.cache_pos = -1       # last CACHE position written (ring index
        #                           source; diverges from pos after a
        #                           mid-episode re-prefill, which restarts
        #                           the cache at window-relative positions)
        self.generation = -1
        self.last_used = 0.0      # monotonic clock of the last touch

    def reset(self, key, generation: int):
        self.key = key
        self.pos = -1
        self.cache_pos = -1
        self.generation = generation
        self.last_used = time.monotonic()


class KVCachePool:
    """``num_slots`` per-episode KV-cache slots over one batched cache on
    ``device``."""

    def __init__(self, arch: ArchConfig, num_slots: int,
                 timeout_s: float = 5.0,
                 reap_idle_s: Optional[float] = 60.0, device="cuda"):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.arch = arch
        self.num_slots = num_slots
        self.scratch_index = num_slots        # pad rows land here
        self.timeout_s = timeout_s
        # Under pool pressure, slots untouched for this long are reclaimed
        # (their client died without releasing).  None disables reaping.
        self.reap_idle_s = reap_idle_s
        self.cache = network.init_cache(arch, num_slots + 1, device)

        self._cond = threading.Condition()
        self._slots = [_Slot(i) for i in range(num_slots)]
        self._free = list(reversed(range(num_slots)))
        self._by_key: Dict[object, _Slot] = {}
        self.generation = 0
        self.stats = {"acquires": 0, "releases": 0, "exhausted_waits": 0,
                      "invalidations": 0, "reaped": 0}

    # --------------------------------------------------------- slot metadata
    def lookup(self, key) -> Optional[_Slot]:
        with self._cond:
            slot = self._by_key.get(key)
            if slot is not None:
                slot.last_used = time.monotonic()
            return slot

    def _release_locked(self, slot: _Slot):
        self._by_key.pop(slot.key, None)
        slot.key = None
        slot.pos = -1
        slot.cache_pos = -1
        self._free.append(slot.index)
        self._cond.notify_all()

    def _reap_idle_locked(self) -> int:
        """Reclaim slots whose holder went silent (worker churn): a live
        episode touches its slot every policy step, so ``reap_idle_s`` of
        silence means the client is gone.  Caller holds the lock."""
        if self.reap_idle_s is None:
            return 0
        cutoff = time.monotonic() - self.reap_idle_s
        stale = [s for s in self._by_key.values() if s.last_used < cutoff]
        for slot in stale:
            self._release_locked(slot)
        self.stats["reaped"] += len(stale)
        return len(stale)

    def acquire(self, key, timeout: Optional[float] = None) -> _Slot:
        """Claim a slot for ``key`` (idempotent: an existing slot is
        returned).  Blocks while all slots are held; raises
        ``CacheSlotsExhausted`` after ``timeout`` seconds."""
        timeout = self.timeout_s if timeout is None else timeout
        with self._cond:
            slot = self._by_key.get(key)
            if slot is not None:
                slot.last_used = time.monotonic()
                return slot
            if not self._free:
                self._reap_idle_locked()
            if not self._free:
                self.stats["exhausted_waits"] += 1
                self._cond.wait_for(lambda: bool(self._free), timeout)
            if not self._free and not self._reap_idle_locked():
                raise CacheSlotsExhausted(
                    f"all {self.num_slots} KV-cache slots held by live "
                    f"episodes (waited {timeout:.1f}s)")
            slot = self._slots[self._free.pop()]
            slot.reset(key, self.generation)
            self._by_key[key] = slot
            self.stats["acquires"] += 1
            return slot

    def release(self, key):
        """Recycle ``key``'s slot (episode end / client disconnect)."""
        with self._cond:
            slot = self._by_key.get(key)
            if slot is None:
                return
            self._release_locked(slot)
            self.stats["releases"] += 1

    def release_prefix(self, key_prefix):
        """Release every slot whose key is a tuple starting with
        ``key_prefix`` — one client's whole env fleet on disconnect."""
        with self._cond:
            keys = [k for k in self._by_key
                    if isinstance(k, tuple) and k and k[0] == key_prefix]
        for k in keys:
            self.release(k)

    def reset_slot(self, slot: _Slot):
        """Recycle a held slot in place (same key, fresh episode): the next
        forward pass must PREFILL, never continue the stale positions."""
        with self._cond:
            slot.pos = -1
            slot.cache_pos = -1
            slot.generation = self.generation

    def invalidate_all(self):
        """Stale-cache rejection: mark every held slot's K/V as computed
        under old weights.  Slots stay held — the next pass re-prefills."""
        with self._cond:
            self.generation += 1
            self.stats["invalidations"] += 1

    def held(self) -> int:
        with self._cond:
            return len(self._by_key)

    # ------------------------------------------------------- device gather
    def gather(self, indices):
        """A copy of rows ``indices`` (a device tensor; slot axis = axis 1:
        leaves are (layers, slots, L, kv_heads, head_dim))."""
        return {"kv": {name: c[:, indices]
                       for name, c in self.cache["kv"].items()}}

    def scatter(self, indices, sub_cache):
        """Write updated rows back in place.  Every pad row repeats the
        scratch index, and a repeated index gets one of its rows in no set
        order; that is harmless only because nothing reads the scratch
        row."""
        for name, c in self.cache["kv"].items():
            c[:, indices] = sub_cache["kv"][name]
