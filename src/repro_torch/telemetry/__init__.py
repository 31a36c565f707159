"""repro_torch.telemetry — the per-process metric registry (a copy of
``repro.telemetry.registry``, which imports no jax; the ``MetricsHub`` comes
with the distributed slice)."""

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
