"""repro_torch.telemetry — run-wide observability for the distributed runtime.

Two layers:

- ``registry``: a per-process ``MetricRegistry`` (counters, gauges,
  bounded-reservoir histograms, snapshot-time probes) plus the
  process-global instance instrumented components record into.  Near-zero
  cost when disabled: metric getters return falsy null objects so hot
  paths skip even their ``time.monotonic()`` calls.
- ``hub``: a courier-addressable ``MetricsHub`` service node every worker
  pushes periodic snapshots to (keyed by node name), with merged run-wide
  views, JSONL export, and an end-of-run text report.

Enable via ``ExperimentConfig(telemetry=True)`` /
``BuilderOptions(telemetry=True)``; the merged snapshot lands in
``ExperimentResult.extras["telemetry"]``.  See ROADMAP "Distributed
telemetry" for the naming convention and how new services register.
"""

from repro_torch.telemetry.registry import (
    DEFAULT_RESERVOIR,
    QUANTILES,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    NULL_METRIC,
    NullMetric,
    configure,
    counter,
    enabled,
    gauge,
    get_registry,
    histogram,
    is_configured,
    merge_snapshots,
    node_name,
    probe,
    quantile,
    snapshot,
    strip_reservoirs,
    timer,
    unconfigure,
)
from repro_torch.telemetry.hub import (
    HUB_INTERFACE,
    MetricsHub,
    MetricsPusher,
    WorkerTelemetry,
    format_report,
)

__all__ = [
    "DEFAULT_RESERVOIR",
    "QUANTILES",
    "Counter",
    "Gauge",
    "Histogram",
    "HUB_INTERFACE",
    "MetricRegistry",
    "MetricsHub",
    "MetricsPusher",
    "NULL_METRIC",
    "NullMetric",
    "WorkerTelemetry",
    "configure",
    "counter",
    "enabled",
    "format_report",
    "gauge",
    "get_registry",
    "histogram",
    "is_configured",
    "merge_snapshots",
    "node_name",
    "probe",
    "quantile",
    "snapshot",
    "strip_reservoirs",
    "timer",
    "unconfigure",
]
