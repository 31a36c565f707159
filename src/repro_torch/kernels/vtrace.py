"""V-trace: the wrapper of the CUDA kernel in ``csrc/vtrace.cu``, which
replaces the Pallas TPU kernel ``repro/kernels/vtrace_kernel.py``.

The wrapper takes CUDA tensors only; ``ops.vtrace`` sends CPU tensors to the
plain version in ``ref.py``.  ``vtrace.launches`` counts the kernel's
launches, so a run can show that its learner steps went through the kernel.
No backward: both outputs enter the IMPALA loss under a stop-gradient, so
the learner calls it on detached inputs.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/vtrace.cu"
REPLACES = "src/repro/kernels/vtrace_kernel.py:23"
_INT_MAX = 2 ** 31 - 1       # T and B reach the kernel as C ints


class VTrace:
    """``(values, next_values, rewards, discounts, rhos) -> (vs, pg_adv)``
    on the card, counting launches."""

    name = "vtrace"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._lib = self._fn = None

    def _kernel(self):
        if self._fn is None:
            lib = build.load(self.name)
            fn = lib.repro_vtrace
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, values, next_values, rewards, discounts, rhos,
                 clip_rho: float = 1.0, clip_c: float = 1.0):
        """Five (T, B) float32 CUDA tensors on one device, T >= 1 and
        B >= 1, in one layout: all contiguous (time-major), or all (T, B)
        transposes of contiguous (B, T) tensors (batch-major, as the IMPALA
        learner holds its sequences).  Returns (vs, pg_adv), each (T, B) in
        the inputs' layout."""
        tensors = (values, next_values, rewards, discounts, rhos)
        if values.device.type != "cuda":
            raise ValueError(
                f"vtrace kernel needs CUDA tensors, got {values.device}")
        if any(t.dtype != torch.float32 for t in tensors):
            raise ValueError("vtrace: inputs must be float32, got "
                             f"{[str(t.dtype) for t in tensors]}")
        if (values.dim() != 2 or any(t.shape != values.shape
                                     for t in tensors)):
            raise ValueError("vtrace: inputs must share one (T, B) shape, got "
                             f"{[tuple(t.shape) for t in tensors]}")
        T, B = values.shape
        if not (1 <= T <= _INT_MAX and 1 <= B <= _INT_MAX):
            raise ValueError(f"vtrace: bad shape (T, B) = {(T, B)}")
        if any(t.device != values.device for t in tensors):
            raise ValueError("vtrace: tensors on different devices")
        batch_major = _layout(tensors)

        fn = self._kernel()
        vs, pg_adv = (torch.empty((B, T) if batch_major else (T, B),
                                  dtype=torch.float32, device=values.device)
                      for _ in range(2))
        if batch_major:
            vs, pg_adv = vs.transpose(0, 1), pg_adv.transpose(0, 1)
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream(values.device).cuda_stream
            code = fn(*(t.data_ptr() for t in tensors), vs.data_ptr(),
                      pg_adv.data_ptr(), T, B, int(batch_major),
                      float(clip_rho), float(clip_c), stream)
        build.check(self._lib, code, "vtrace launch")
        with self._lock:
            self.launches += 1
        return vs, pg_adv


def _layout(tensors) -> bool:
    """Whether the five (T, B) tensors are batch-major (each the transpose
    of a contiguous (B, T) tensor) rather than time-major (contiguous);
    raises unless all five are one or the other."""
    if all(t.is_contiguous() for t in tensors):
        return False
    if all(t.transpose(0, 1).is_contiguous() for t in tensors):
        return True
    raise ValueError(
        "vtrace: the five inputs must share one layout, contiguous (T, B) or "
        "the (T, B) transposes of contiguous (B, T) tensors; got strides "
        f"{[t.stride() for t in tensors]}")


vtrace = VTrace()
