"""repro_torch.telemetry — the per-process metric registry, the run-wide
``MetricsHub`` every worker pushes snapshots to, and the worker-side
``MetricsPusher`` and its picklable ``WorkerTelemetry`` bootstrap (copies
of ``repro.telemetry.registry`` and ``repro.telemetry.hub``, which import
no jax; the port keeps its own)."""

from repro_torch.telemetry.registry import (  # noqa: F401
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
from repro_torch.telemetry.hub import (  # noqa: F401
    HUB_INTERFACE,
    MetricsHub,
    MetricsPusher,
    WorkerTelemetry,
    format_report,
)
