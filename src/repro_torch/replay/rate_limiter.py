"""Reverb-style rate limitation (§2.5 of the paper).

``SampleToInsertRatio`` enforces a target samples-per-insert (SPI) ratio with
an error tolerance: whichever side runs ahead *blocks* until the other
catches up.  The invariant maintained (and property-tested) is

    min_size_to_sample <= inserts         (before any sample)
    |samples - spi * (inserts - min_size)| <= tolerance   (while unblocked)

Implemented with a single condition variable, usable from many actor threads
and one or more learner threads simultaneously.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional


class RateLimiterTimeout(RuntimeError):
    pass


class RateLimiterInterrupt(RuntimeError):
    """A blocked waiter was woken by its ``interrupt`` predicate (e.g. the
    owning table was marked down for simulated failover) — nothing was
    counted; the caller decides whether to surface an error or re-wait."""


class RateLimiter:
    """Base: unlimited (MinSize behaviour with min_size_to_sample)."""

    def __init__(self, min_size_to_sample: int = 1):
        self.min_size_to_sample = max(int(min_size_to_sample), 1)
        self._lock = threading.Condition()
        self._inserts = 0
        self._samples = 0
        self._stopped = False

    # -- statistics --------------------------------------------------
    @property
    def inserts(self) -> int:
        return self._inserts

    @property
    def samples(self) -> int:
        return self._samples

    @property
    def stopped(self) -> bool:
        return self._stopped

    def stop(self):
        with self._lock:
            self._stopped = True
            self._lock.notify_all()

    # -- exact-resume serialization -----------------------------------
    def state_dict(self) -> dict:
        with self._lock:
            return {"inserts": self._inserts, "samples": self._samples}

    def load_state_dict(self, state: dict):
        with self._lock:
            self._inserts = int(state["inserts"])
            self._samples = int(state["samples"])
            self._lock.notify_all()

    # -- blocking predicates (override) -------------------------------
    def _can_insert(self) -> bool:
        return True

    def _can_sample(self) -> bool:
        return self._inserts >= self.min_size_to_sample

    # -- public api ----------------------------------------------------
    def notify_waiters(self):
        """Wake every blocked waiter so it re-evaluates its predicate —
        used by ``interrupt`` sources (they flip their flag, then call
        this; without it a parked waiter would sleep through the event)."""
        with self._lock:
            self._lock.notify_all()

    def await_can_insert(self, timeout: Optional[float] = None,
                         interrupt: Optional[Callable[[], bool]] = None):
        def _interrupted():
            return interrupt is not None and interrupt()

        with self._lock:
            if not self._lock.wait_for(
                    lambda: self._can_insert() or self._stopped
                    or _interrupted(), timeout):
                raise RateLimiterTimeout("insert blocked past timeout")
            if _interrupted():
                raise RateLimiterInterrupt("insert waiter interrupted")
            if self._stopped and not self._can_insert():
                raise RateLimiterTimeout("stopped")
            self._inserts += 1
            self._lock.notify_all()

    def rollback_sample(self):
        """Un-count one admitted sample: the table had no item to serve (a
        consuming selector drained it between admission and the draw)."""
        with self._lock:
            self._samples -= 1
            self._lock.notify_all()

    def await_can_sample(self, timeout: Optional[float] = None,
                         interrupt: Optional[Callable[[], bool]] = None):
        def _interrupted():
            return interrupt is not None and interrupt()

        with self._lock:
            if not self._lock.wait_for(
                    lambda: self._can_sample() or self._stopped
                    or _interrupted(), timeout):
                raise RateLimiterTimeout("sample blocked past timeout")
            if _interrupted():
                raise RateLimiterInterrupt("sample waiter interrupted")
            if self._stopped and not self._can_sample():
                raise RateLimiterTimeout("stopped")
            self._samples += 1
            self._lock.notify_all()

    def would_block_insert(self) -> bool:
        with self._lock:
            return not self._can_insert()

    def would_block_sample(self) -> bool:
        with self._lock:
            return not self._can_sample()


class SampleToInsertRatio(RateLimiter):
    """Block to keep samples ≈ spi * inserts within ±tolerance samples.

    Matches Reverb's SampleToInsertRatio semantics: let
    ``d = samples - spi * (inserts - min_size_to_sample)``; inserting is
    allowed while d > -tolerance (learner not too far behind), sampling is
    allowed while d < tolerance (learner not too far ahead) and the table has
    reached min size.
    """

    def __init__(self, samples_per_insert: float, min_size_to_sample: int,
                 error_buffer: float):
        super().__init__(min_size_to_sample)
        if samples_per_insert <= 0:
            raise ValueError("samples_per_insert must be > 0")
        self.spi = float(samples_per_insert)
        self.error_buffer = float(error_buffer)
        min_diff = -error_buffer
        if self.spi * self.min_size_to_sample + min_diff > 0:
            # ensure the first min_size inserts are never blocked
            self.error_buffer = self.spi * self.min_size_to_sample

    def _deficit(self) -> float:
        return self._samples - self.spi * (self._inserts - self.min_size_to_sample)

    def _can_insert(self) -> bool:
        # an insert is allowed if, AFTER it, the learner lags by at most the
        # error buffer: samples - spi*(inserts+1-min) >= -error_buffer.
        if self._inserts < self.min_size_to_sample:
            return True
        after = self._samples - self.spi * (self._inserts + 1
                                            - self.min_size_to_sample)
        return after >= -self.error_buffer

    def _can_sample(self) -> bool:
        if self._inserts < self.min_size_to_sample:
            return False
        return self._deficit() < self.error_buffer - 1


class MinSize(RateLimiter):
    """Only requirement: table has at least min_size items (no ratio)."""
