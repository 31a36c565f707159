"""Mamba2 SSD chunk scan: the wrapper of the CUDA kernel in
``csrc/ssd_scan.cu``, which replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py``.

The wrapper takes CUDA tensors only; ``ops.ssd_scan`` sends CPU tensors to
the plain version in ``ref.py``.  ``ssd_scan.launches`` counts the kernel's
calls, so a run can show that its Mamba2 layers went through the kernel; each
call launches four CUDA kernels in order on the current stream (cumulative
sums and scores, chunk states, state passing, chunk scan).  Unlike the
Pallas kernel it also takes an initial state and returns the final one, so
the model's ``ssd_chunked`` maps onto it whole.

The kernel computes the forward pass only.  ``SSDScanFunction`` makes it
differentiable: its forward launches the kernel, and its backward
recomputes the scan through the plain version and differentiates that,
for both outputs (y and the final state) and for h0 when it was given.
The recompute is the correctness route, not a design (a backward kernel
is still to be written); it launches no kernel, so ``launches`` counts
forward launches only.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:26"
HEAD_DIMS = (16, 32, 64, 128)     # p
MAX_STATE = 128                   # n
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 65535                 # the grids' y (heads) and z (batch) extents
_INT_MAX = 2 ** 31 - 1


class SSDScan:
    """``(x, dt, A, B, C, chunk, h0) -> (y, final_state)`` on the card,
    counting launches."""

    name = "ssd_scan"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._lib = self._fn = None

    def _kernel(self):
        if self._fn is None:
            lib = build.load(self.name)
            fn = lib.repro_ssd_scan
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, x, dt, A, B, C, chunk: int = 256, h0=None):
        """x: (b, s, h, p) float32 or bfloat16; dt: (b, s, h) and A: (h,)
        float32; B, C: (b, s, n) in x's dtype; ``chunk`` <= 256 divides s;
        h0: optional (b, h, n, p) float32 initial state.  Contiguous, on one
        CUDA device.  Returns (y (b, s, h, p), final_state (b, h, n, p)),
        both float32."""
        if x.device.type != "cuda":
            raise ValueError(
                f"ssd_scan kernel needs CUDA tensors, got {x.device}")
        if (x.dtype not in _DTYPES or B.dtype != x.dtype
                or C.dtype != x.dtype or dt.dtype != torch.float32
                or A.dtype != torch.float32
                or (h0 is not None and h0.dtype != torch.float32)):
            raise ValueError(
                f"ssd_scan: dtypes x {x.dtype} B {B.dtype} C {C.dtype} dt "
                f"{dt.dtype} A {A.dtype}; x, B and C need one of "
                f"{sorted(map(str, _DTYPES))}, dt, A and h0 float32")
        if x.dim() != 4:
            raise ValueError(f"ssd_scan: bad shape x {tuple(x.shape)}")
        b, s, h, p = x.shape
        n = B.shape[-1] if B.dim() == 3 else -1
        if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n)
                or C.shape != B.shape
                or (h0 is not None and h0.shape != (b, h, n, p))
                or not 1 <= b <= _MAX_GRID or not 1 <= h <= _MAX_GRID
                or not 1 <= s <= _INT_MAX):
            raise ValueError(
                f"ssd_scan: bad shapes x {tuple(x.shape)} dt "
                f"{tuple(dt.shape)} A {tuple(A.shape)} B {tuple(B.shape)} C "
                f"{tuple(C.shape)} h0 "
                f"{None if h0 is None else tuple(h0.shape)}")
        if p not in HEAD_DIMS:
            raise ValueError(f"ssd_scan: head_dim {p} not in {HEAD_DIMS}")
        if not 1 <= n <= MAX_STATE:
            raise ValueError(f"ssd_scan: d_state {n} not in 1..{MAX_STATE}")
        if not 1 <= chunk <= MAX_CHUNK or s % chunk:
            raise ValueError(f"ssd_scan: chunk {chunk} must be in "
                             f"1..{MAX_CHUNK} and divide s = {s}")
        tensors = [x, dt, A, B, C] + ([] if h0 is None else [h0])
        if any(t.device != x.device for t in tensors):
            raise ValueError("ssd_scan: tensors on different devices")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("ssd_scan: tensors must be contiguous")

        fn = self._kernel()
        y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        final = torch.empty((b, h, n, p), dtype=torch.float32,
                            device=x.device)
        # scratch, written before it is read: the f64 cumulative sums, the
        # scores C.B^T of every chunk, and the chunk states
        nc = s // chunk
        cum = torch.empty((b, s, h), dtype=torch.float64, device=x.device)
        scores = torch.empty((b, nc, chunk, chunk), dtype=torch.float32,
                             device=x.device)
        states = torch.empty((b, nc, h, n, p), dtype=torch.float32,
                             device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                      B.data_ptr(), C.data_ptr(),
                      None if h0 is None else h0.data_ptr(), y.data_ptr(),
                      final.data_ptr(), cum.data_ptr(), scores.data_ptr(),
                      states.data_ptr(), b, s, h, p, n, chunk,
                      _DTYPES[x.dtype], stream)
        build.check(self._lib, code, "ssd_scan launch")
        with self._lock:
            self.launches += 1
        return y, final


ssd_scan = SSDScan()


class SSDScanFunction(torch.autograd.Function):
    """``apply(x, dt, A, B, C, h0, chunk) -> (y, final_state)``: the
    kernel's forward (counted), and a backward that recomputes the plain
    version from the saved inputs and returns its gradients with respect
    to x, dt, A, B, C and h0 (None when h0 was None).  A failed build or
    launch in the forward raises, as without autograd."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0, chunk):
        ctx.save_for_backward(x, dt, A, B, C, h0)
        ctx.chunk = chunk
        return ssd_scan(x, dt, A, B, C, chunk, h0)

    @staticmethod
    def backward(ctx, grad_y, grad_final):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            y, final = ref.ssd_scan_ref(*inputs[:5], ctx.chunk, h0=inputs[5])
            grads = iter(torch.autograd.grad(
                (y, final), [t for t in inputs if t is not None
                             and t.requires_grad],
                (grad_y, grad_final), allow_unused=True))
        return tuple(next(grads) if need else None for need in needs) + (
            None,)
