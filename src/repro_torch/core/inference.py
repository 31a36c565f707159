"""SEED-style batched inference: the request-coalescing server.

Actors stop evaluating the policy themselves: their client actor forwards
``select_action`` to ONE server, which coalesces concurrent requests from
many actors into a single batched forward pass — one model dispatch per
coalescing window instead of one per actor per env step.

Coalescing window semantics
---------------------------
A batcher thread collects requests under two bounds:

- ``max_batch_size``: total observation ROWS per forward pass (a vectorized
  actor's request contributes ``num_envs`` rows).  A request that would
  overflow the window waits for the next batch — requests are never split.
- ``max_wait_ms``: once the FIRST request of a window arrives, the batch is
  closed after at most this long even if not full.  A lone actor therefore
  pays at most ``max_wait_ms`` extra latency; a busy service fills batches
  before the deadline and the wait never triggers.

``stop()`` fails pending and future callers with ``CourierClosed``.

The machinery is ``_BatchingServer``; a service supplies ``_execute``
(``repro_torch.policies.serving`` runs the stateful KV-cache policy engine
there).  The feed-forward ``InferenceServer`` comes with the DQN slice.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.courier import CourierClosed
from repro_torch.telemetry import registry as _telemetry


class _Request:
    __slots__ = ("payload", "rows", "event", "result", "error", "t0")

    def __init__(self, payload: Any, rows: int):
        self.payload = payload
        self.rows = rows
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t0: Optional[float] = None   # submit time (telemetry only)


class _BatchingServer:
    """Request coalescing, the batcher thread, and shutdown plumbing.

    Subclasses call ``_submit(payload, rows)`` from their RPC methods and
    implement ``_execute(batch) -> (results, extra_stats)`` where
    ``results`` has one entry per request (assigned in order) and
    ``extra_stats`` maps stat names to increments merged under the lock.
    """

    def __init__(self, max_batch_size: int = 64, max_wait_ms: float = 2.0):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, "
                             f"got {max_batch_size}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self._max_batch = int(max_batch_size)
        self._max_wait_s = float(max_wait_ms) / 1000.0

        self._cond = threading.Condition()
        self._pending: List[_Request] = []
        self._stopped = False
        self._stats: Dict[str, Any] = {"requests": 0, "rows": 0, "batches": 0}
        # Null (falsy) metrics when telemetry is off — the hot paths below
        # guard their clock reads on truthiness.
        self._m_queue_wait = _telemetry.histogram("inference/queue_wait_ms")
        self._m_batch_rows = _telemetry.histogram("inference/batch_rows")
        self._m_batch_occupancy = _telemetry.histogram(
            "inference/batch_occupancy")
        _telemetry.probe("inference/server", self.stats)
        self._thread = threading.Thread(target=self._batch_loop,
                                        name="inference_server",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- RPC side
    def _submit(self, payload: Any, rows: int):
        """Enqueue one request and block until its rows come back from a
        coalesced forward pass.  Raises ``CourierClosed`` once stopped."""
        if rows > self._max_batch:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch_size="
                f"{self._max_batch}")
        request = _Request(payload, rows)
        if self._m_queue_wait:
            request.t0 = time.monotonic()
        with self._cond:
            if self._stopped:
                raise CourierClosed("inference server stopped")
            self._pending.append(request)
            self._cond.notify_all()
        request.event.wait()
        if request.error is not None:
            raise request.error
        return request.result

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            s = dict(self._stats)
        s["avg_rows_per_batch"] = s["rows"] / max(s["batches"], 1)
        s["max_batch_size"] = self._max_batch
        s["max_wait_ms"] = self._max_wait_s * 1000.0
        return s

    def stop(self):
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=5)

    # ------------------------------------------------------- batcher thread
    def _execute(self, batch: List[_Request]) -> Tuple[Sequence[Any],
                                                       Dict[str, Any]]:
        raise NotImplementedError

    def _collect(self) -> List[_Request]:
        """Block until a coalescing window closes; return its requests."""
        with self._cond:
            batch: List[_Request] = []
            rows = 0
            deadline = None
            while True:
                while (self._pending
                       and rows + self._pending[0].rows <= self._max_batch):
                    request = self._pending.pop(0)
                    batch.append(request)
                    rows += request.rows
                if self._stopped or rows >= self._max_batch:
                    return batch
                if not batch:
                    # idle: nothing to coalesce yet, no deadline running
                    self._cond.wait(0.1)
                    continue
                if self._pending:
                    return batch   # head request would overflow the window
                if deadline is None:
                    deadline = time.monotonic() + self._max_wait_s
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return batch
                self._cond.wait(remaining)

    def _run_batch(self, batch: List[_Request]):
        if self._m_queue_wait:
            now = time.monotonic()
            rows = 0
            for request in batch:
                rows += request.rows
                if request.t0 is not None:
                    self._m_queue_wait.observe((now - request.t0) * 1000.0)
            self._m_batch_rows.observe(rows)
            self._m_batch_occupancy.observe(rows / self._max_batch)
        try:
            results, extra = self._execute(batch)
            with self._cond:
                self._stats["batches"] += 1
                self._stats["requests"] += len(batch)
                self._stats["rows"] += sum(r.rows for r in batch)
                for k, v in extra.items():
                    self._stats[k] = self._stats.get(k, 0) + v
            for request, result in zip(batch, results):
                request.result = result
                request.event.set()
        except Exception as e:   # noqa: BLE001 — each caller re-raises it
            for request in batch:
                request.error = e
                request.event.set()

    def _fail_pending(self):
        with self._cond:
            pending, self._pending = self._pending, []
        for request in pending:
            request.error = CourierClosed("inference server stopped")
            request.event.set()

    def _batch_loop(self):
        while True:
            batch = self._collect()
            if batch:
                self._run_batch(batch)
            with self._cond:
                if self._stopped:
                    break
        self._fail_pending()
