"""Loggers (the §4.2 measurement apparatus): terminal, CSV, in-memory, and
fan-out — pluggable anywhere a ``logger`` callable is accepted (environment
loops, learners, evaluators)."""
from __future__ import annotations

import csv
import numbers
import os
import threading
import time
from typing import Any, Dict, List, Optional


def _format_value(v: Any) -> str:
    """``:.3f`` for any non-integral real number — including numpy float
    scalars, which are not ``float`` instances and would otherwise print as
    raw reprs like ``0.12300000339746475``."""
    if isinstance(v, numbers.Real) and not isinstance(v, numbers.Integral):
        return f"{float(v):.3f}"
    return str(v)


class TerminalLogger:
    def __init__(self, label: str = "", every_s: float = 0.0):
        self.label = label
        self.every_s = every_s
        self._last = 0.0

    def __call__(self, values: Dict[str, Any]):
        now = time.time()
        if now - self._last < self.every_s:
            return
        self._last = now
        items = ", ".join(f"{k}={_format_value(v)}"
                          for k, v in sorted(values.items()))
        print(f"[{self.label}] {items}", flush=True)


class CSVLogger:
    """Appends rows; writes the header from the first row's keys."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._fieldnames: Optional[List[str]] = None

    def __call__(self, values: Dict[str, Any]):
        with self._lock:
            new = not os.path.exists(self.path)
            if self._fieldnames is None:
                if new:
                    self._fieldnames = sorted(values)
                else:
                    with open(self.path) as f:
                        try:
                            self._fieldnames = next(csv.reader(f))
                        except StopIteration:
                            # existing but EMPTY file (e.g. created by
                            # ``touch`` or a crashed run): treat as new
                            self._fieldnames = sorted(values)
                            new = True
            with open(self.path, "a", newline="") as f:
                w = csv.DictWriter(f, self._fieldnames, extrasaction="ignore")
                if new:
                    w.writeheader()
                w.writerow(values)


class InMemoryLogger:
    def __init__(self):
        self.rows: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def __call__(self, values: Dict[str, Any]):
        with self._lock:
            self.rows.append(dict(values))


class Dispatcher:
    def __init__(self, *loggers):
        self.loggers = loggers

    def __call__(self, values: Dict[str, Any]):
        for lg in self.loggers:
            lg(values)
