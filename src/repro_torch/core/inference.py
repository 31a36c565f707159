"""SEED-style batched inference service (the Tier-2 half of batched acting).

Remote actor workers stop evaluating the policy themselves: their
``InferenceClientActor`` forwards ``select_action(observations)`` to ONE
``InferenceServer`` service node, which coalesces concurrent requests from
many workers into a single batched forward pass on the server's device.  N
actor processes then cost one model call per coalescing window instead of
one per actor per env step — the SEED-RL economics, on the Launchpad-lite
graph.

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

Observation batches are zero-padded up to the next power-of-two bucket
(<= ``max_batch_size``) so the device sees a handful of shapes, not one per
distinct request mix; padded rows are dropped before replies fan back out.

The server owns the weights: a ``VariableClient`` on the learner is
refreshed once per ``update_period`` BATCHES (not per request), so weight
traffic scales with forward passes, not with actors; the numpy params go to
the device once per refresh.  Exploration draws come from a
``torch.Generator`` seeded with ``(rng_seed, batch counter)`` before each
pass, as the batched actors seed theirs from their step counter.
``stop()`` fails pending and future callers with ``CourierClosed`` — a
ConnectionError, which launcher shutdown-noise classification already
treats as benign once a stop is in flight.

The coalescing machinery is factored into ``_BatchingServer`` so services
with richer request shapes (``repro_torch.policies``' stateful KV-cache
serving) reuse the window/queue/shutdown semantics and only supply
``_execute``.
"""
from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.actors import _PolicyRunner
from repro_torch.core.variable import VariableClient
from repro_torch.distributed.courier import CourierClosed
from repro_torch.telemetry import registry as _telemetry

# The RPC surface a Program node wrapping this server should declare.
INFERENCE_INTERFACE = ("select_action", "stats")


def policy_is_feed_forward(policy: Callable) -> bool:
    """True when ``policy`` has the (params, generator, obs) arity the
    batched inference path can call; recurrent policies carry a 4th state
    argument the server would have to track per client (not supported)."""
    try:
        params = inspect.signature(policy).parameters
    except (TypeError, ValueError):
        return True   # builtins and C callables: assume feed-forward
    positional = [p for p in params.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if any(p.kind == p.VAR_POSITIONAL for p in params.values()):
        return True
    return len(positional) == 3


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


class InferenceServer(_BatchingServer):
    """Coalesce ``select_action`` requests into one batched forward pass.

    ``policy`` is the batched behaviour policy ``(params, generator, obs)
    -> actions`` every builder already provides; ``variable_source`` is
    anything with ``get_variables`` (the learner, or a handle to it).  The
    pass runs on ``device``.
    """

    def __init__(self, policy: Callable, variable_source,
                 max_batch_size: int = 64, max_wait_ms: float = 2.0,
                 update_period: int = 10, rng_seed: int = 0,
                 device="cuda"):
        if not policy_is_feed_forward(policy):
            raise ValueError(
                "InferenceServer batches feed-forward policies "
                "(params, generator, obs); recurrent policies would need "
                "per-client state tracking — use inference='local' for "
                "those agents")
        self._client = VariableClient(variable_source,
                                      update_period=max(update_period, 1))
        # the batched actors' scheme: the generator is seeded from
        # (rng_seed, batch counter) before each pass
        self._run = _PolicyRunner(policy, self._client, rng_seed, device)
        super().__init__(max_batch_size=max_batch_size,
                         max_wait_ms=max_wait_ms)
        with self._cond:
            self._stats.setdefault("padded_rows", 0)

    def select_action(self, observations) -> np.ndarray:
        """Batch in, batch out: ``(k, *obs_shape) -> (k, *action_shape)``.

        Blocks until this request's rows come back from a coalesced forward
        pass.  Raises ``CourierClosed`` once the server is stopped.
        """
        obs = np.asarray(observations)
        return self._submit(obs, obs.shape[0])

    def _execute(self, batch: List[_Request]):
        rows = sum(r.rows for r in batch)
        obs = np.concatenate([r.payload for r in batch], axis=0)
        # pad to a power-of-two bucket: a bounded set of shapes
        bucket = 1
        while bucket < rows:
            bucket *= 2
        bucket = min(bucket, self._max_batch)
        if obs.shape[0] < bucket:
            pad = np.zeros((bucket - obs.shape[0],) + obs.shape[1:],
                           obs.dtype)
            obs = np.concatenate([obs, pad], axis=0)
        self._client.update()   # period counts BATCHES, not requests
        actions = self._run(obs).cpu().numpy()
        results = []
        offset = 0
        for request in batch:
            results.append(actions[offset:offset + request.rows])
            offset += request.rows
        return results, {"padded_rows": bucket - rows}
