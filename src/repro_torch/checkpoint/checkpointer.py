"""Pytree checkpointing (npz): learner state + counters persist through
interruptions; learner walltime is checkpointed alongside the networks so
timekeeping survives preemption (§4.2).

The file format is the JAX package's: one ``leaf_{i}`` array per leaf, in
JAX's leaf order (``repro_torch.tree``), and a ``__meta__`` JSON string.
So a checkpoint written by either package restores into the other.
Tensors are saved from the CPU; ``restore`` puts each leaf on the device
of the template's tensor at its place (a leaf whose template is not a
tensor comes back as a numpy array, as in the JAX package).

Crash-consistency contract: ``save`` publishes a ``<name>_latest.json``
manifest (atomic replace + directory fsync) *after* the npz itself is in
place and *before* garbage collection, so a crash at any point leaves
``restore()`` pointing at a fully written step — never at a half-collected
or half-written one.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree


class CheckpointError(RuntimeError):
    """A checkpoint exists but cannot be restored into the given template
    (leaf count or leaf shape mismatch, or a manifest pointing at a missing
    file)."""


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(state) -> Tuple[Dict[str, np.ndarray], Any]:
    leaves, treedef = tree.flatten(state)
    return {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}, treedef


def _like(template, arr: np.ndarray):
    """``arr`` as the template leaf's kind: a tensor on its device, else
    the array itself."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(arr).to(template.device)
    return arr


def fsync_directory(directory: str):
    """Flush directory metadata (renames) to disk; no-op where unsupported."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class Checkpointer:
    def __init__(self, directory: str, name: str = "checkpoint",
                 keep: int = 3):
        self.directory = directory
        self.name = name
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.name}_{step}.npz")

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, f"{self.name}_latest.json")

    def save(self, state, step: int, metadata: Optional[Dict] = None):
        arrays, treedef = _flatten(state)
        meta = dict(metadata or {})
        meta["step"] = step
        # atomic write
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(fd)
        np.savez(tmp, __meta__=json.dumps(meta), **arrays)
        src = tmp + ".npz"          # np.savez appends .npz
        os.replace(src, self._path(step))
        if os.path.exists(tmp):
            os.unlink(tmp)
        # Publish the manifest before gc: if we crash mid-collection,
        # restore() still resolves to this (complete) step rather than
        # scanning a directory that gc may have half-emptied.
        self._write_manifest(step)
        fsync_directory(self.directory)
        self._gc()

    def _write_manifest(self, step: int):
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".json.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({"step": step,
                       "file": os.path.basename(self._path(step))}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())

    def latest_step(self) -> Optional[int]:
        """The manifest's step if present (crash-safe), else the newest
        on-disk step, else None."""
        try:
            with open(self._manifest_path()) as f:
                manifest = json.load(f)
            step = int(manifest["step"])
        except (OSError, ValueError, KeyError):
            steps = self.list_steps()
            return steps[-1] if steps else None
        if not os.path.exists(self._path(step)):
            raise CheckpointError(
                f"manifest {self._manifest_path()} points at step {step} "
                f"but {self._path(step)} is missing")
        return step

    def _gc(self):
        ckpts = self.list_steps()
        keep = ckpts[-self.keep:]
        latest = None
        try:
            latest = self.latest_step()
        except CheckpointError:
            pass
        for step in ckpts:
            if step not in keep and step != latest:
                os.unlink(self._path(step))

    def list_steps(self):
        steps = []
        for f in os.listdir(self.directory):
            if f.startswith(self.name + "_") and f.endswith(".npz"):
                try:
                    steps.append(int(f[len(self.name) + 1:-4]))
                except ValueError:
                    pass
        return sorted(steps)

    def restore(self, state_template, step: Optional[int] = None):
        """Returns (state, metadata) or (None, None) if nothing saved.

        Raises ``CheckpointError`` when the checkpoint's leaf count or any
        leaf's shape does not match ``state_template`` — a clear signal the
        network/optimizer architecture drifted from the saved run.
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                return None, None
        path = self._path(step)
        if not os.path.exists(path):
            raise CheckpointError(f"no checkpoint at step {step}: {path}")
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            leaves, treedef = tree.flatten(state_template)
            saved = sum(1 for k in data.files if k.startswith("leaf_"))
            if saved != len(leaves):
                raise CheckpointError(
                    f"checkpoint {os.path.basename(path)} has {saved} "
                    f"leaves but the template has {len(leaves)} — the "
                    "state structure changed since this checkpoint was "
                    "written")
            restored = []
            for i, leaf in enumerate(leaves):
                arr = data[f"leaf_{i}"]
                want = tuple(leaf.shape) if isinstance(
                    leaf, torch.Tensor) else np.shape(leaf)
                if tuple(arr.shape) != tuple(want):
                    raise CheckpointError(
                        f"checkpoint {os.path.basename(path)} leaf_{i} has "
                        f"shape {tuple(arr.shape)} but the template expects "
                        f"{tuple(want)}")
                restored.append(_like(leaf, arr))
            state = tree.unflatten(treedef, restored)
        return state, meta
