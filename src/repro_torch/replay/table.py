"""Reverb-lite: an in-process, thread-safe replay table.

Items are arbitrary pytrees of numpy arrays (inserted by adders).  Selectors
implement Reverb's sampling distributions: Fifo, Lifo, Uniform, Prioritized.
Removal on overflow is FIFO.  The table enforces its RateLimiter on both
insert and sample paths, reproducing §2.5's blocking behaviour.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.replay.rate_limiter import (RateLimiter, RateLimiterInterrupt,
                                       RateLimiterTimeout, MinSize)
from repro_torch.replay.selectors import Selector, Uniform
from repro_torch.telemetry import registry as _telemetry


class Item:
    __slots__ = ("key", "data", "priority")

    def __init__(self, key: int, data: Any, priority: float):
        self.key = key
        self.data = data
        self.priority = priority


class Table:
    def __init__(self, name: str, capacity: int,
                 selector: Optional[Selector] = None,
                 rate_limiter: Optional[RateLimiter] = None):
        self.name = name
        self.capacity = int(capacity)
        self.selector = selector or Uniform()
        self.rate_limiter = rate_limiter or MinSize(1)
        self._lock = threading.Lock()
        self._items: Dict[int, Item] = {}
        # Insertion order for FIFO removal.  An OrderedDict (a doubly linked
        # list underneath) gives O(1) pop-oldest on eviction and O(1) removal
        # of arbitrary keys for consuming selectors, where a plain list was
        # O(n) per operation at full capacity.
        self._order: "OrderedDict[int, None]" = OrderedDict()
        self._next_key = 0
        # Simulated-death flag (service failover): while set, the
        # data path refuses calls so in-parent clients see the same outage
        # remote clients get from the torn-down courier server.
        self._down = threading.Event()
        # Block-time metrics are created on FIRST use, not here:
        # ``ShardedReplay.from_factory`` renames its shard tables after
        # construction, and the metric name must carry the final name.
        self._m_insert_block = None
        self._m_sample_block = None

    # --------------------------------------------------- service failover
    def mark_down(self):
        """Simulate abrupt service death: insert/sample/update_priorities
        raise ``ServiceUnavailable`` until ``mark_up``.  Metadata reads
        (``size``/``state_dict``) stay available — the failover watchdog
        and telemetry probes still need them.  Waiters already parked in
        the rate limiter are woken so they fail too, instead of sleeping
        through the outage holding the SPI coupling wedged."""
        self._down.set()
        self.rate_limiter.notify_waiters()

    def mark_up(self):
        self._down.clear()
        self.rate_limiter.notify_waiters()

    def _await_limiter(self, awaiter, timeout):
        """Run a limiter wait that fails over: while the table is down the
        wait raises ``ServiceUnavailable`` (via the interrupt hook) rather
        than parking a thread through the outage; a spurious wake-up that
        raced ``mark_up`` simply re-waits."""
        while True:
            try:
                return awaiter(timeout, interrupt=self._down.is_set)
            except RateLimiterInterrupt:
                self._check_up()

    def _check_up(self):
        if self._down.is_set():
            from repro_torch.distributed.courier import ServiceUnavailable
            raise ServiceUnavailable(
                f"replay table {self.name!r} is down (simulated failure; "
                f"awaiting failover)")

    def _block_metrics(self):
        if self._m_insert_block is None:
            # "replay"/"replay/shard_i" names already carry the component
            # prefix; others ("queue", "demos") get it prepended.
            base = (self.name if self.name.split("/")[0] == "replay"
                    else f"replay/{self.name}")
            self._m_insert_block = _telemetry.histogram(
                f"{base}/insert_block_ms")
            self._m_sample_block = _telemetry.histogram(
                f"{base}/sample_block_ms")
        return self._m_insert_block, self._m_sample_block

    # ------------------------------------------------------------ insert
    def insert(self, data: Any, priority: float = 1.0,
               timeout: Optional[float] = None) -> int:
        self._check_up()
        m_insert, _ = self._block_metrics()
        if m_insert:
            t0 = time.monotonic()
            self._await_limiter(self.rate_limiter.await_can_insert, timeout)
            m_insert.observe((time.monotonic() - t0) * 1000.0)
        else:
            self._await_limiter(self.rate_limiter.await_can_insert, timeout)
        with self._lock:
            key = self._next_key
            self._next_key += 1
            self._items[key] = Item(key, data, priority)
            self._order[key] = None
            self.selector.insert(key, priority)
            while len(self._order) > self.capacity:
                evict, _ = self._order.popitem(last=False)
                self._items.pop(evict, None)
                self.selector.remove(evict)
            return key

    # ------------------------------------------------------------ sample
    def sample(self, batch_size: int = 1,
               timeout: Optional[float] = None) -> List[Tuple[Item, float]]:
        """Returns [(item, importance_weight_probability), ...]."""
        self._check_up()
        out = []
        _, m_sample = self._block_metrics()
        deadline = None if timeout is None else time.time() + timeout
        for _ in range(batch_size):
            while True:
                self._check_up()
                remaining = (None if deadline is None
                             else max(deadline - time.time(), 0.0))
                if m_sample:
                    t0 = time.monotonic()
                    self._await_limiter(self.rate_limiter.await_can_sample,
                                        remaining)
                    m_sample.observe((time.monotonic() - t0) * 1000.0)
                else:
                    self._await_limiter(self.rate_limiter.await_can_sample,
                                        remaining)
                with self._lock:
                    try:
                        key, prob = self.selector.sample()
                    except IndexError:
                        key = None   # admitted, but the table is empty
                    else:
                        out.append((self._items[key], prob))
                        if getattr(self.selector, "consumes", False):
                            self._items.pop(key, None)
                            self._order.pop(key, None)
                if key is not None:
                    break
                # The limiter admits on cumulative inserts, but a consuming
                # selector may have drained the table: un-count the sample
                # and wait for the next insert instead of crashing.
                self.rate_limiter.rollback_sample()
                if deadline is not None and time.time() >= deadline:
                    raise RateLimiterTimeout("sample blocked past timeout")
                time.sleep(0.001)
        return out

    def update_priorities(self, keys: Sequence[int], priorities: Sequence[float]):
        self._check_up()
        with self._lock:
            for k, p in zip(keys, priorities):
                if k in self._items:
                    self._items[k].priority = float(p)
                    self.selector.update(k, float(p))

    def size(self) -> int:
        with self._lock:
            return len(self._order)

    # ----------------------------------------------------- exact resume
    def state_dict(self) -> Dict[str, Any]:
        """A consistent snapshot of the table: items (in insertion order,
        so FIFO eviction resumes identically), priorities, the key counter,
        selector internals, and rate-limiter accounting."""
        with self._lock:
            try:
                selector_state = self.selector.state_dict()
            except NotImplementedError:
                selector_state = None
            return {
                "name": self.name,
                "capacity": self.capacity,
                "items": [(k, self._items[k].data, self._items[k].priority)
                          for k in self._order],
                "next_key": self._next_key,
                "selector": selector_state,
                "rate_limiter": self.rate_limiter.state_dict(),
            }

    def load_state_dict(self, state: Dict[str, Any]):
        """Restore into a freshly built table (same capacity/selector/
        limiter construction as at save time)."""
        with self._lock:
            self._items.clear()
            self._order.clear()
            for key, data, priority in state["items"]:
                key = int(key)
                self._items[key] = Item(key, data, float(priority))
                self._order[key] = None
            self._next_key = int(state["next_key"])
            if state.get("selector") is not None:
                self.selector.load_state_dict(state["selector"])
            else:
                # Best-effort rebuild for selectors without exact-resume
                # support: same membership and priorities, fresh RNG stream.
                for key, _, priority in state["items"]:
                    self.selector.insert(int(key), float(priority))
        self.rate_limiter.load_state_dict(state["rate_limiter"])

    @property
    def stopped(self) -> bool:
        return self.rate_limiter.stopped

    def stop(self):
        self.rate_limiter.stop()
