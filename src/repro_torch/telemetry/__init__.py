"""repro_torch.telemetry — the per-process metric registry and the
run-wide ``MetricsHub`` (copies of ``repro.telemetry.registry`` and of the
hub in ``repro.telemetry.hub``, which import no jax; the port keeps its
own).  The hub's pusher thread comes with the distributed slice."""

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
from repro_torch.telemetry.hub import MetricsHub, format_report  # noqa: F401
