"""The transformer-policy inference service.

A ``_BatchingServer`` (the coalescing window / queue / shutdown machinery
from ``repro_torch.core.inference``) whose execute step is a
``PolicyEngine`` pass: requests carry observation WINDOWS plus episode
steps, the engine routes each row to batched prefill or incremental
KV-cache decode against its per-episode cache slot, and one forward pass
(on the CUDA ``decode_attention`` kernel for decode, on the card) answers
the whole coalesced batch.

Weights come from a ``VariableClient`` on the learner, refreshed once per
``update_period`` batches; a refresh invalidates every live cache slot
(stale-cache rejection), so the next pass re-prefills rather than mixing
old K/V with new queries.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.inference import _BatchingServer, _Request
from repro_torch.core.variable import VariableClient


class TransformerInferenceServer(_BatchingServer):
    """Coalesce windowed ``select_action`` requests into engine passes."""

    INTERFACE = ("select_action", "window", "release", "stats")

    def __init__(self, engine, variable_source, max_batch_size: int = 64,
                 max_wait_ms: float = 2.0, update_period: int = 10):
        self._engine = engine
        self._client = VariableClient(variable_source,
                                      update_period=max(update_period, 1))
        super().__init__(max_batch_size=max_batch_size,
                         max_wait_ms=max_wait_ms)

    # ------------------------------------------------------------- RPC side
    def select_action(self, windows, positions, client_id) -> np.ndarray:
        """windows: (k, W, *obs_shape) left-aligned; positions: (k,) episode
        steps of each row's newest frame; ``client_id`` namespaces the
        cache-slot keys (row i -> key ``(client_id, i)``)."""
        windows = np.asarray(windows, np.float32)
        positions = np.asarray(positions, np.int64)
        return self._submit((windows, positions, client_id),
                            windows.shape[0])

    def window(self) -> int:
        """The policy's observation-window length (clients size buffers)."""
        return int(self._engine.window)

    def release(self, client_id):
        """Free every cache slot held for ``client_id`` (disconnect)."""
        self._engine.release_client(client_id)

    def stats(self):
        s = super().stats()
        s.update(self._engine.stats())
        return s

    # ------------------------------------------------------- batcher thread
    def _execute(self, batch: List[_Request]):
        windows = np.concatenate([r.payload[0] for r in batch], axis=0)
        positions = np.concatenate([r.payload[1] for r in batch], axis=0)
        keys = []
        for request in batch:
            client_id = request.payload[2]
            keys.extend((client_id, i) for i in range(request.rows))
        self._client.update()   # period counts BATCHES, not requests
        actions = self._engine.select(self._client.params, keys, windows,
                                      positions)
        results = []
        offset = 0
        for request in batch:
            results.append(actions[offset:offset + request.rows])
            offset += request.rows
        return results, {}
