"""Per-process metric registry: counters, gauges, bounded-reservoir
histograms, and snapshot-time probes.

The §4.2 loggers record *rows a component chose to emit*; the registry
records *what the hot paths actually did* — call latencies, queue waits,
batch occupancies, block times — cheaply enough to leave on in production
runs and at literally-zero cost when off:

- When a registry is DISABLED, ``counter()``/``gauge()``/``histogram()``
  return a shared null metric whose mutators are no-ops and whose truth
  value is ``False`` — hot paths guard their ``time.monotonic()`` calls
  with ``if self._m_latency:`` so a disabled run pays one truthiness check
  per event and nothing else.
- When ENABLED, every metric is individually locked (no registry-wide
  bottleneck on the sample path) and ``snapshot()`` returns plain-python
  summaries that pickle across courier and dump to JSON unchanged.

Metric naming convention: ``component/detail/metric`` (e.g.
``courier/client/replay/insert/latency_ms``); the NODE prefix of the
run-wide ``node/component/metric`` convention is added by the
``MetricsHub``, which keys pushed snapshots by the pushing node's name.

Histograms keep a bounded reservoir (Vitter's algorithm R): a uniform
sample of everything observed, so quantiles stay honest at any event count
with O(1) memory.  Snapshots carry the reservoir so the hub can merge
cross-node quantiles instead of averaging percentiles (which is wrong).

Probes cover state that has no event to hook: ``probe(prefix, fn)``
registers a callable returning ``{suffix: value}`` that is evaluated at
``snapshot()`` time and exported as gauges named ``prefix/suffix`` —
replay occupancy, cache-slot utilization, averaging rounds.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

DEFAULT_RESERVOIR = 512
QUANTILES = (0.5, 0.95, 0.99)


def quantile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile of an already-SORTED sequence
    (numpy's default method, without the numpy dependency)."""
    if not values:
        return float("nan")
    if len(values) == 1:
        return float(values[0])
    pos = q * (len(values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    frac = pos - lo
    return float(values[lo] * (1.0 - frac) + values[hi] * frac)


class NullMetric:
    """Shared do-nothing stand-in returned by a disabled registry.

    Falsy on purpose: hot paths write ``t0 = time.monotonic() if
    self._metric else 0.0`` so a disabled run never even reads the clock.
    """

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def inc(self, n: int = 1):
        pass

    def set(self, value: float):
        pass

    def observe(self, value: float):
        pass


NULL_METRIC = NullMetric()


class Counter:
    """Monotonic event count (merge rule across nodes: SUM)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1):
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written level (merge rule across nodes: mean/min/max)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Bounded-reservoir distribution with p50/p95/p99 summaries.

    Reservoir sampling (algorithm R) keeps a uniform sample of ALL
    observations in ``max_samples`` slots; count/sum/min/max are exact.
    The RNG is seeded from the metric name so runs are reproducible.
    """

    __slots__ = ("name", "max_samples", "_lock", "_rng", "_reservoir",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, max_samples: int = DEFAULT_RESERVOIR):
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.name = name
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._rng = random.Random(hash(name) & 0xFFFFFFFF)
        self._reservoir: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, value: float):
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if len(self._reservoir) < self.max_samples:
                self._reservoir.append(value)
            else:
                j = self._rng.randrange(self._count)
                if j < self.max_samples:
                    self._reservoir[j] = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
            reservoir = list(self._reservoir)
        if count == 0:
            return {"type": "histogram", "count": 0}
        reservoir.sort()
        summary = {
            "type": "histogram",
            "count": count,
            "sum": total,
            "mean": total / count,
            "min": lo,
            "max": hi,
            "reservoir": reservoir,
        }
        for q in QUANTILES:
            summary[f"p{int(q * 100)}"] = quantile(reservoir, q)
        return summary


class _TimerContext:
    __slots__ = ("_histogram", "_t0")

    def __init__(self, histogram: Histogram):
        self._histogram = histogram

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._histogram.observe((time.monotonic() - self._t0) * 1000.0)
        return False


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


def timer(histogram):
    """``with timer(hist):`` — observe the block's duration in ms; a null
    (falsy) histogram yields a no-op context that never reads the clock."""
    return _TimerContext(histogram) if histogram else _NULL_TIMER


class MetricRegistry:
    """One process's (or node's) metrics, keyed by name.

    ``counter``/``gauge``/``histogram`` create-or-return the named metric;
    asking for an existing name with a different type is an error (two
    components silently sharing one metric is a bug, not a merge).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._probes: Dict[str, Callable[[], Mapping[str, float]]] = {}

    # ------------------------------------------------------------- creation
    def _get_or_create(self, name: str, cls, *args):
        if not self.enabled:
            return NULL_METRIC
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, *args)
                self._metrics[name] = metric
            elif not isinstance(metric, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(metric).__name__}, not {cls.__name__}")
            return metric

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  max_samples: int = DEFAULT_RESERVOIR) -> Histogram:
        return self._get_or_create(name, Histogram, max_samples)

    def probe(self, prefix: str, fn: Callable[[], Mapping[str, float]]):
        """Register ``fn`` to be evaluated at snapshot time; its
        ``{suffix: value}`` result is exported as gauges named
        ``prefix/suffix``.  A colliding prefix is auto-suffixed ``#2``,
        ``#3``, … (several engines/pools may coexist in one process)."""
        if not self.enabled:
            return
        with self._lock:
            key = prefix
            n = 2
            while key in self._probes:
                key = f"{prefix}#{n}"
                n += 1
            self._probes[key] = fn

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Plain-python summary of every metric and probe — picklable over
        courier and JSON-serializable once reservoirs are stripped."""
        with self._lock:
            metrics = dict(self._metrics)
            probes = dict(self._probes)
        out: Dict[str, Dict[str, Any]] = {}
        for name, metric in metrics.items():
            out[name] = metric.snapshot()
        for prefix, fn in probes.items():
            try:
                values = fn()
            except Exception:   # a dying component must not break telemetry
                continue
            for suffix, value in values.items():
                try:
                    out[f"{prefix}/{suffix}"] = {"type": "gauge",
                                                 "value": float(value)}
                except (TypeError, ValueError):
                    continue   # non-numeric probe outputs are skipped
        return out

    def reset(self):
        with self._lock:
            self._metrics.clear()
            self._probes.clear()


def merge_snapshots(
        node_snapshots: Mapping[str, Mapping[str, Mapping[str, Any]]],
) -> Dict[str, Dict[str, Any]]:
    """Merge per-node snapshots into one run-wide view, keyed by metric
    name.  Counters SUM; gauges report mean/min/max across nodes;
    histograms combine exact count/sum/min/max and recompute quantiles
    from the concatenated reservoirs (averaging percentiles would be
    statistically wrong).  Every merged entry carries ``nodes`` — how many
    nodes contributed."""
    by_name: Dict[str, List[Mapping[str, Any]]] = {}
    for snapshot in node_snapshots.values():
        for name, summary in snapshot.items():
            by_name.setdefault(name, []).append(summary)

    merged: Dict[str, Dict[str, Any]] = {}
    for name, summaries in by_name.items():
        kind = summaries[0].get("type")
        if any(s.get("type") != kind for s in summaries):
            continue   # same name, different types across nodes: skip
        if kind == "counter":
            merged[name] = {"type": "counter",
                            "value": sum(s["value"] for s in summaries),
                            "nodes": len(summaries)}
        elif kind == "gauge":
            values = [s["value"] for s in summaries]
            merged[name] = {"type": "gauge",
                            "mean": sum(values) / len(values),
                            "min": min(values), "max": max(values),
                            "nodes": len(summaries)}
        elif kind == "histogram":
            live = [s for s in summaries if s.get("count", 0) > 0]
            if not live:
                merged[name] = {"type": "histogram", "count": 0,
                                "nodes": len(summaries)}
                continue
            count = sum(s["count"] for s in live)
            total = sum(s["sum"] for s in live)
            reservoir: List[float] = []
            for s in live:
                reservoir.extend(s.get("reservoir", ()))
            reservoir.sort()
            entry = {"type": "histogram", "count": count, "sum": total,
                     "mean": total / count,
                     "min": min(s["min"] for s in live),
                     "max": max(s["max"] for s in live),
                     "nodes": len(summaries)}
            for q in QUANTILES:
                entry[f"p{int(q * 100)}"] = quantile(reservoir, q)
            merged[name] = entry
    return merged


def strip_reservoirs(
        snapshot: Mapping[str, Mapping[str, Any]]) -> Dict[str, Dict]:
    """Summary-only copy of a snapshot (for JSONL export / extras views)."""
    out = {}
    for name, summary in snapshot.items():
        out[name] = {k: v for k, v in summary.items() if k != "reservoir"}
    return out


# ---------------------------------------------------------------------------
# Process-global registry.
#
# Instrumented components (courier, batching server, replay tables, …) pull
# their metrics from here so instrumentation needs no plumbing: the run
# entrypoint calls ``configure(...)`` once per process and every component
# constructed afterwards picks it up.  Until then the default registry is
# DISABLED and unconfigured — importing repro costs nothing, and
# ``WorkerTelemetry.install()`` uses ``is_configured()`` to tell a fresh
# spawn child (configure + start pusher) from a local-launcher worker
# sharing an already-configured parent (no-op).
# ---------------------------------------------------------------------------

_GLOBAL_LOCK = threading.Lock()
_GLOBAL_REGISTRY = MetricRegistry(enabled=False)
_GLOBAL_NODE = "unconfigured"
_GLOBAL_CONFIGURED = False


def configure(enabled: bool = True, node: str = "local") -> MetricRegistry:
    """(Re)configure this process's registry — called once per process by
    the run entrypoint (or ``WorkerTelemetry.install()`` in spawn
    children).  Always starts from a FRESH registry so metrics from a
    previous run in the same process can't leak into this one."""
    global _GLOBAL_REGISTRY, _GLOBAL_NODE, _GLOBAL_CONFIGURED
    with _GLOBAL_LOCK:
        _GLOBAL_REGISTRY = MetricRegistry(enabled=enabled)
        _GLOBAL_NODE = node
        _GLOBAL_CONFIGURED = True
        return _GLOBAL_REGISTRY


def unconfigure():
    """Reset to the import-time state (disabled, unconfigured) — used by
    run teardown so back-to-back runs in one process each reconfigure."""
    global _GLOBAL_REGISTRY, _GLOBAL_NODE, _GLOBAL_CONFIGURED
    with _GLOBAL_LOCK:
        _GLOBAL_REGISTRY = MetricRegistry(enabled=False)
        _GLOBAL_NODE = "unconfigured"
        _GLOBAL_CONFIGURED = False


def get_registry() -> MetricRegistry:
    return _GLOBAL_REGISTRY


def enabled() -> bool:
    return _GLOBAL_REGISTRY.enabled


def is_configured() -> bool:
    return _GLOBAL_CONFIGURED


def node_name() -> str:
    return _GLOBAL_NODE


def counter(name: str) -> Counter:
    return _GLOBAL_REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _GLOBAL_REGISTRY.gauge(name)


def histogram(name: str, max_samples: int = DEFAULT_RESERVOIR) -> Histogram:
    return _GLOBAL_REGISTRY.histogram(name, max_samples)


def probe(prefix: str, fn: Callable[[], Mapping[str, float]]):
    return _GLOBAL_REGISTRY.probe(prefix, fn)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return _GLOBAL_REGISTRY.snapshot()
