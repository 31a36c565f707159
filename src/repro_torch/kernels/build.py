"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
in ``_build/`` (listed in ``.gitignore``).  The file name carries a hash of
every source under ``csrc/`` and of the compiler flags, so a changed source
or flag builds anew and an unchanged one is loaded as it is.  Builds run at
first use; ``build`` starts one ``nvcc`` per missing library, all at once.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in sorted(CSRC.iterdir()):
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, with one
    ``nvcc`` process each, started together.  Returns, per name, the build
    seconds (0.0 when it was already built) and the compiler's output, which
    holds ptxas's register and shared-memory report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    started = {}
    report = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            log = target.with_suffix(".log")
            report[name] = {"seconds": 0.0,
                            "log": log.read_text() if log.exists() else ""}
            continue
        compiler = compiler or nvcc()
        partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        command = [compiler, *NVCC_FLAGS, "-o", str(partial),
                   str(CSRC / f"{name}.cu")]
        process = subprocess.Popen(command, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
        started[name] = (process, partial, target, time.monotonic())
    for name, (process, partial, target, t0) in started.items():
        log, _ = process.communicate()
        seconds = time.monotonic() - t0
        if process.returncode != 0:
            partial.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {name} "
                               f"(exit {process.returncode}):\n{log}")
        target.with_suffix(".log").write_text(log)
        os.replace(partial, target)
        report[name] = {"seconds": seconds, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiled first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        message = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({message})")
