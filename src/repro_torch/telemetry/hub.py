"""Run-wide metrics aggregation: the ``MetricsHub``.

The hub keeps the LATEST snapshot per node (metrics are cumulative, so
the latest supersedes earlier pushes), merges them on demand via
``merge_snapshots``, optionally appends every push to a JSONL file
(reservoirs stripped — summaries only), and renders an end-of-run text
report.  ``run_experiment`` pushes its one process's snapshot at the end of
a run.  The worker-side ``MetricsPusher``, its ``WorkerTelemetry``
bootstrap and the courier RPC allowlist of the JAX package's
``repro/telemetry/hub.py`` come with the distributed programs that use them
(ROADMAP slice 7).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Mapping, Optional

from repro_torch.telemetry.registry import (QUANTILES, merge_snapshots,
                                            strip_reservoirs)


class MetricsHub:
    """Aggregates per-node metric snapshots into one run-wide view.

    Thread-safe: in a distributed run every worker pushes from its own
    connection thread.
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
