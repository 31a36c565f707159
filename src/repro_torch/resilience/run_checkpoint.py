"""Run-wide exact-resume checkpointing.

``RunCheckpointer`` coordinates one consistent snapshot of everything a
run needs to restart bit-for-bit:

- the learner pytree (via the existing npz ``Checkpointer``, under the
  ``learner`` name: leaves in JAX order, tensors saved from the CPU and
  restored to the template's device);
- replay *contents* — ``Table.state_dict()`` / ``ShardedReplay
  .state_dict()``: items, priorities, selector internals (sum-tree array
  verbatim, RNG streams), rate-limiter accounting, routing cursors;
- counter totals and run bookkeeping (RNG/cadence counters, loop
  position), passed as opaque picklable dicts.

Write protocol (crash-safe at every boundary):

1. each component is written to a temp file, fsynced, and ``os.replace``d
   into ``learner_<step>.npz`` / ``replay_<step>.pkl`` /
   ``runstate_<step>.pkl``;
2. only then is the ``run_latest.json`` manifest atomically replaced and
   the directory fsynced — the manifest is the unit of atomicity: a crash
   anywhere earlier leaves the previous manifest (and its files, which gc
   never touches) fully intact;
3. garbage collection of steps older than ``keep`` runs last.

``restore`` reads the manifest, verifies every listed file exists
(``CheckpointError`` otherwise), and returns a ``RunSnapshot``.
"""
from __future__ import annotations

import json
import os
import pickle
import tempfile
import time
from typing import Any, Dict, NamedTuple, Optional

from repro_torch.checkpoint import (Checkpointer, CheckpointError,
                                    fsync_directory)
from repro_torch.telemetry import registry as _telemetry

MANIFEST = "run_latest.json"


class RunSnapshot(NamedTuple):
    step: int
    learner_state: Any
    replay: Optional[Dict]        # Table/ShardedReplay state_dict, or None
    counts: Optional[Dict]        # Counter totals
    run_state: Optional[Dict]     # RNG streams, cadence counters, loop pos.
    meta: Dict


class RunCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._learner = Checkpointer(directory, name="learner", keep=keep)
        self._m_write = None
        self._m_restore = None

    def _metrics(self):
        if self._m_write is None:
            self._m_write = _telemetry.histogram(
                "resilience/checkpoint_write_ms")
            self._m_restore = _telemetry.histogram(
                "resilience/checkpoint_restore_ms")
        return self._m_write, self._m_restore

    # ------------------------------------------------------------ paths
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST)

    def _component_path(self, component: str, step: int) -> str:
        return os.path.join(self.directory, f"{component}_{step}.pkl")

    def _write_pickle(self, path: str, payload: Any):
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".pkl.tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # ------------------------------------------------------------- save
    def save(self, step: int, learner_state: Any, *,
             replay: Optional[Dict] = None,
             counts: Optional[Dict] = None,
             run_state: Optional[Dict] = None,
             meta: Optional[Dict] = None):
        m_write, _ = self._metrics()
        t0 = time.monotonic()
        step = int(step)
        files = {"learner": f"learner_{step}.npz"}
        self._learner.save(learner_state, step)
        if replay is not None:
            path = self._component_path("replay", step)
            self._write_pickle(path, replay)
            files["replay"] = os.path.basename(path)
        runstate_path = self._component_path("runstate", step)
        self._write_pickle(runstate_path, {"counts": counts,
                                           "run_state": run_state})
        files["runstate"] = os.path.basename(runstate_path)
        # Manifest last: everything it references is already durable.
        manifest = {"step": step, "files": files, "meta": dict(meta or {})}
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".json.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())
        fsync_directory(self.directory)
        self._gc(step)
        if m_write:
            m_write.observe((time.monotonic() - t0) * 1000.0)

    def _gc(self, latest: int):
        steps = self.list_steps()
        keep = set(steps[-self.keep:]) | {latest}
        for step in steps:
            if step in keep:
                continue
            for component in ("replay", "runstate"):
                path = self._component_path(component, step)
                if os.path.exists(path):
                    os.unlink(path)

    def list_steps(self):
        steps = set()
        for f in os.listdir(self.directory):
            if f.startswith("runstate_") and f.endswith(".pkl"):
                try:
                    steps.add(int(f[len("runstate_"):-4]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        manifest = self._read_manifest()
        return None if manifest is None else int(manifest["step"])

    def _read_manifest(self) -> Optional[Dict]:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except OSError:
            return None
        except ValueError as e:
            raise CheckpointError(
                f"corrupt run manifest {self._manifest_path()}: {e}")

    # ---------------------------------------------------------- restore
    def restore(self, learner_template: Any) -> Optional[RunSnapshot]:
        """Restore the manifest's snapshot, or None when nothing saved."""
        manifest = self._read_manifest()
        if manifest is None:
            return None
        _, m_restore = self._metrics()
        t0 = time.monotonic()
        step = int(manifest["step"])
        files = manifest.get("files", {})
        for component, name in files.items():
            path = os.path.join(self.directory, name)
            if not os.path.exists(path):
                raise CheckpointError(
                    f"run manifest points at step {step} but {component} "
                    f"file {name} is missing")
        learner_state, _ = self._learner.restore(learner_template, step)
        replay = None
        if "replay" in files:
            with open(os.path.join(self.directory, files["replay"]),
                      "rb") as f:
                replay = pickle.load(f)
        with open(os.path.join(self.directory, files["runstate"]),
                  "rb") as f:
            runstate = pickle.load(f)
        snapshot = RunSnapshot(step=step, learner_state=learner_state,
                               replay=replay,
                               counts=runstate.get("counts"),
                               run_state=runstate.get("run_state"),
                               meta=manifest.get("meta", {}))
        if m_restore:
            m_restore.observe((time.monotonic() - t0) * 1000.0)
        return snapshot
