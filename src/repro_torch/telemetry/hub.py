"""Run-wide metrics aggregation: the ``MetricsHub`` service node and the
``MetricsPusher`` that feeds it.

Push model, not pull: every worker process runs one daemon
``MetricsPusher`` thread that periodically snapshots its process-local
``MetricRegistry`` and calls ``hub.push(node, snapshot)`` — over courier
when the hub lives in another process (multiprocess launcher), or as a
plain method call when everything shares the parent (local launcher).
Pull would require the hub to hold a handle to every worker; push means a
new service registers itself just by pushing, and a crashed worker's last
snapshot survives in the hub.

The hub keeps the LATEST snapshot per node (metrics are cumulative, so
the latest supersedes earlier pushes), merges them on demand via
``merge_snapshots``, optionally appends every push to a JSONL file
(reservoirs stripped — summaries only), and renders an end-of-run text
report.  ``HUB_INTERFACE`` is the courier RPC allowlist for the service
node.

``WorkerTelemetry`` is the picklable bootstrap that rides into spawn
children as a worker kwarg: calling ``install()`` configures the child's
process-global registry and starts its pusher — unless the process is
already configured (local launcher: all "workers" share the parent, whose
single pusher covers them), in which case it is a no-op.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Dict, Mapping, Optional

from repro_torch.telemetry import registry as _registry
from repro_torch.telemetry.registry import (QUANTILES, merge_snapshots,
                                            strip_reservoirs)

# Courier RPC allowlist for the hub's Program service node.
HUB_INTERFACE = ("push", "snapshot", "nodes", "report", "num_pushes")


class MetricsHub:
    """Aggregates per-node metric snapshots into one run-wide view.

    Thread-safe: courier serves each connection on its own thread, so
    concurrent pushes from many workers are the normal case.
    """

    def __init__(self, jsonl_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._snapshots: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self._pushes = 0
        self._jsonl_path = jsonl_path
        self._jsonl_file = open(jsonl_path, "a") if jsonl_path else None

    def push(self, node: str, snapshot: Mapping[str, Mapping[str, Any]],
             timestamp: Optional[float] = None) -> int:
        """Store ``node``'s latest snapshot; returns total pushes seen."""
        snapshot = dict(snapshot)
        with self._lock:
            self._snapshots[node] = snapshot
            self._pushes += 1
            pushes = self._pushes
            if self._jsonl_file is not None:
                record = {"node": node,
                          "time": time.time() if timestamp is None
                          else timestamp,
                          "metrics": strip_reservoirs(snapshot)}
                self._jsonl_file.write(json.dumps(record) + "\n")
                self._jsonl_file.flush()
        return pushes

    def snapshot(self) -> Dict[str, Any]:
        """Merged run-wide view: per-node summaries (reservoirs stripped)
        plus cross-node merged metrics."""
        with self._lock:
            per_node = {node: dict(snap)
                        for node, snap in self._snapshots.items()}
            pushes = self._pushes
        return {
            "nodes": {node: strip_reservoirs(snap)
                      for node, snap in per_node.items()},
            "merged": strip_reservoirs(merge_snapshots(per_node)),
            "num_nodes": len(per_node),
            "num_pushes": pushes,
        }

    def nodes(self) -> list:
        with self._lock:
            return sorted(self._snapshots)

    def num_pushes(self) -> int:
        with self._lock:
            return self._pushes

    def report(self) -> str:
        """End-of-run text summary of the merged view."""
        return format_report(self.snapshot())

    def stop(self):
        """Flush and close the JSONL export; aggregated data stays
        readable (run teardown snapshots the hub after stopping it)."""
        with self._lock:
            if self._jsonl_file is not None:
                self._jsonl_file.close()
                self._jsonl_file = None


def format_report(snapshot: Mapping[str, Any]) -> str:
    """Render a hub snapshot as an aligned, human-readable table."""
    lines = [f"=== telemetry: {snapshot['num_nodes']} node(s), "
             f"{snapshot['num_pushes']} push(es) ===",
             "nodes: " + ", ".join(sorted(snapshot["nodes"]))]
    merged = snapshot["merged"]
    if merged:
        width = min(max(len(name) for name in merged), 60)
    for name in sorted(merged):
        entry = merged[name]
        kind = entry["type"]
        if kind == "counter":
            detail = f"count={entry['value']}"
        elif kind == "gauge":
            if "mean" in entry:
                detail = (f"mean={entry['mean']:.3f} "
                          f"min={entry['min']:.3f} max={entry['max']:.3f}")
            else:
                detail = f"value={entry['value']:.3f}"
        else:   # histogram
            if entry.get("count", 0) == 0:
                detail = "count=0"
            else:
                qs = " ".join(f"p{int(q * 100)}={entry[f'p{int(q * 100)}']:.3f}"
                              for q in QUANTILES)
                detail = (f"count={entry['count']} "
                          f"mean={entry['mean']:.3f} {qs} "
                          f"max={entry['max']:.3f}")
        lines.append(f"  {name:<{width}}  {detail}")
    return "\n".join(lines)


class MetricsPusher:
    """Daemon thread pushing this process's registry snapshot to the hub
    every ``period_s``, with a final push on ``stop()`` so short-lived
    workers still report.  A dead or restarting hub must never take down
    the worker: failed pushes are dropped, counted in
    ``telemetry/push_failures``, and logged ONCE per outage (not per
    period).  Because pushes carry the full cumulative snapshot and the
    hub keeps the latest per node, the first successful push after the
    hub returns re-registers this worker with nothing lost but the outage
    window's sampling."""

    def __init__(self, hub, node: str, period_s: float = 0.5):
        self._hub = hub
        self._node = node
        self._period_s = period_s
        self._stop_event = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"metrics-pusher-{node}", daemon=True)
        self._started = False
        self.push_failures = 0
        self._outage = False
        self._m_failures = None

    def start(self) -> "MetricsPusher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def _push_once(self):
        try:
            self._hub.push(self._node, _registry.snapshot())
        except Exception as e:
            self.push_failures += 1
            if self._m_failures is None and _registry.enabled():
                self._m_failures = _registry.counter("telemetry/push_failures")
            if self._m_failures:
                self._m_failures.inc()
            if not self._outage:
                self._outage = True
                print(f"[telemetry] {self._node}: hub push failed "
                      f"({type(e).__name__}: {e}) — dropping pushes until "
                      f"the hub returns", file=sys.stderr, flush=True)
            return
        if self._outage:
            self._outage = False
            print(f"[telemetry] {self._node}: hub reachable again after "
                  f"{self.push_failures} dropped pushes — re-registered",
                  file=sys.stderr, flush=True)

    def _run(self):
        while not self._stop_event.wait(self._period_s):
            self._push_once()

    def stop(self, timeout: float = 5.0):
        if not self._started:
            return
        self._stop_event.set()
        self._thread.join(timeout)
        self._push_once()   # final flush AFTER the loop exits: no race


class WorkerTelemetry:
    """Picklable telemetry bootstrap handed to worker nodes.

    Carries the hub handle (a courier ``RemoteHandle`` once pickled into a
    spawn child) plus this worker's node name and push period.
    ``install()`` is called first thing in the worker's ``__init__``:

    - In a fresh spawn child the process registry is unconfigured →
      configure it enabled and start a pusher (returned for teardown).
    - Under the local launcher the parent already configured the process
      and runs its own pusher → no-op, returns None.  (Per-worker node
      attribution is a multiprocess-launcher feature; in-process workers
      share one registry by construction.)
    """

    def __init__(self, hub, node: str, period_s: float = 0.5):
        self.hub = hub
        self.node = node
        self.period_s = period_s

    def install(self) -> Optional[MetricsPusher]:
        if _registry.is_configured():
            return None
        _registry.configure(enabled=True, node=self.node)
        return MetricsPusher(self.hub, self.node, self.period_s).start()
