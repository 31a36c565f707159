"""Dataset iterators over replay tables (the learner-facing stream, §2.3).

``as_iterator`` yields batched pytrees (numpy, stacked along axis 0) exactly
like Acme's TF-Dataset-over-Reverb, including the sampled keys and
probabilities needed for prioritized replay importance weighting.
"""
from __future__ import annotations

from typing import Any, Iterator, NamedTuple, Optional

import numpy as np

from repro_torch import tree
from repro_torch.replay.table import Table


class SampleInfo(NamedTuple):
    keys: np.ndarray
    probabilities: np.ndarray


class ReplaySample(NamedTuple):
    info: SampleInfo
    data: Any


def batch_from_samples(sampled) -> ReplaySample:
    """Assemble ``[(Item, prob), ...]`` into one stacked ReplaySample."""
    items = [it.data for it, _ in sampled]
    keys = np.array([it.key for it, _ in sampled], np.int64)
    probs = np.array([p for _, p in sampled], np.float64)
    return ReplaySample(SampleInfo(keys, probs), tree.stack(items))


class _TableIterator:
    """The infinite sample stream as a plain-class iterator, NOT a
    generator: an exception escaping a generator's frame (e.g. a transient
    ``ServiceUnavailable`` while the table's service restarts) finalizes
    the generator, and every later ``next()`` returns ``StopIteration`` —
    which learner run loops read as clean end-of-stream and exit on.  A
    class iterator has no frame to finalize: the exception propagates to
    the caller and the stream resumes on the next ``next()``."""

    __slots__ = ("_table", "_batch_size", "_timeout")

    def __init__(self, table, batch_size: int, timeout: Optional[float]):
        self._table = table
        self._batch_size = batch_size
        self._timeout = timeout

    def __iter__(self):
        return self

    def __next__(self) -> ReplaySample:
        return batch_from_samples(
            self._table.sample(self._batch_size, timeout=self._timeout))


def as_iterator(table: Table, batch_size: int,
                timeout: float = None) -> Iterator[ReplaySample]:
    return _TableIterator(table, batch_size, timeout)


def dataset_from_list(items, batch_size: int, *, seed: int = 0,
                      shuffle: bool = True) -> Iterator[ReplaySample]:
    """Offline dataset (§2.6/§3.7): iterate a fixed list of items forever."""
    rng = np.random.RandomState(seed)
    n = len(items)
    while True:
        idx = rng.randint(0, n, size=batch_size) if shuffle \
            else np.arange(batch_size) % n
        batch = [items[i] for i in idx]
        info = SampleInfo(np.asarray(idx, np.int64),
                          np.full(batch_size, 1.0 / n))
        yield ReplaySample(info, tree.stack(batch))
