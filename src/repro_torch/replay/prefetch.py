"""Prefetching learner pipeline (§2.3's dataset, off the hot path).

``as_iterator`` samples and stacks a batch *synchronously* inside the
learner's step — the learner pays replay latency (lock waits, rate-limiter
blocking, numpy stacking) on every batch.  ``PrefetchingDataset`` moves that
work onto background sampler threads feeding a bounded queue: the learner's
``next()`` is a queue pop, and sampling overlaps with gradient computation.

Two sources:

- ``PrefetchingDataset(table, batch_size, num_threads=k)`` — samples the
  table (or ``ShardedReplay``) directly from ``k`` threads; the fast path
  when the learner batch is plain ``as_iterator`` sampling.
- ``PrefetchingDataset.over_iterator(iterator)`` — wraps *any* batch
  iterator (e.g. DQfD/R2D3's demo-mixing dataset) with one background
  thread, preserving its exact sampling semantics.

The queue bound keeps the pipeline honest with respect to the §2.5 rate
limiter: at most ``prefetch_size`` batches are accounted to the limiter
ahead of what the learner has actually consumed.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

from repro_torch.replay.dataset import ReplaySample, batch_from_samples
from repro_torch.replay.rate_limiter import RateLimiterTimeout


class PrefetchingDataset:
    """Iterator of ``ReplaySample`` batches assembled by background threads.

    table: anything with ``sample(batch_size, timeout)`` and a ``stopped``
        property — a ``Table`` or a ``ShardedReplay``.
    batch_size: items per batch.
    prefetch_size: bounded queue depth (batches buffered ahead).
    num_threads: background sampler threads (>1 overlaps rate-limiter
        blocking and shard-lock waits across batches).
    """

    def __init__(self, table, batch_size: int, prefetch_size: int = 4,
                 num_threads: int = 1, poll_s: float = 0.2,
                 _iterator: Optional[Iterator[ReplaySample]] = None):
        if prefetch_size < 1:
            raise ValueError(
                f"prefetch_size must be >= 1, got {prefetch_size}")
        if num_threads < 1:
            raise ValueError(f"num_threads must be >= 1, got {num_threads}")
        if _iterator is None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._table = table
        self._batch_size = batch_size
        self._iterator = _iterator
        self._poll_s = poll_s
        self._queue: "queue.Queue[ReplaySample]" = queue.Queue(prefetch_size)
        self._stop_event = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"prefetch_{i}")
            for i in range(num_threads)]
        for t in self._threads:
            t.start()

    @classmethod
    def over_iterator(cls, iterator: Iterator[ReplaySample],
                      prefetch_size: int = 4,
                      poll_s: float = 0.2) -> "PrefetchingDataset":
        """Wrap an arbitrary batch iterator (single background thread — an
        iterator is not safe to advance concurrently)."""
        return cls(table=None, batch_size=0, prefetch_size=prefetch_size,
                   num_threads=1, poll_s=poll_s, _iterator=iterator)

    # ------------------------------------------------------------ workers
    def _produce(self) -> ReplaySample:
        if self._iterator is not None:
            return next(self._iterator)
        sampled = self._table.sample(self._batch_size, timeout=self._poll_s)
        return batch_from_samples(sampled)

    def _worker(self):
        while not self._stop_event.is_set():
            try:
                batch = self._produce()
            except StopIteration:
                self._stop_event.set()
                return
            except RateLimiterTimeout as e:
                if "stopped" in str(e) or getattr(self._table, "stopped",
                                                  False):
                    self._stop_event.set()
                continue
            while not self._stop_event.is_set():
                try:
                    self._queue.put(batch, timeout=self._poll_s)
                    break
                except queue.Full:
                    continue

    # ------------------------------------------------------------ iterator
    def __iter__(self):
        return self

    def __next__(self) -> ReplaySample:
        while True:
            try:
                return self._queue.get(timeout=self._poll_s)
            except queue.Empty:
                if self._stop_event.is_set():
                    raise RateLimiterTimeout("stopped")

    def qsize(self) -> int:
        return self._queue.qsize()

    def stop(self, timeout: Optional[float] = 2.0):
        self._stop_event.set()
        for t in self._threads:
            t.join(timeout)

    @property
    def closed(self) -> bool:
        return self._stop_event.is_set()

    def close(self, timeout: Optional[float] = 2.0):
        """Stop + drain: join the sampler threads and empty the queue so a
        stopped learner node releases its buffered batches — sequential
        runs in one process cannot accumulate leaked prefetch threads or
        buffered sample memory.  Idempotent; a consumer blocked in
        ``next()`` is woken with the "stopped" timeout."""
        self.stop(timeout)
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return
