"""Mamba2 SSD chunk scan: the wrappers of the CUDA kernels in
``csrc/ssd_scan.cu`` (the forward, which replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py``) and ``csrc/ssd_scan_bwd.cu`` (its
backward), both on TF32 ``wgmma`` through the pipeline of
``csrc/ssd_pipe.cuh``.

The wrappers take CUDA tensors only; ``ops.ssd_scan`` sends CPU tensors to
the plain version in ``ref.py``.  ``ssd_scan.launches`` and
``ssd_scan_bwd.launches`` count each kernel's calls, so a run can show that
its Mamba2 layers, and their gradients, went through the kernels.  A
forward call launches three CUDA kernels in order on the current stream
(the chunk launch: cumulative sums, scores and chunk states; state
passing; the output), a backward call six (local states, state passing
backwards, dx, dG, dt, the sums).  Both are bound by operations; every
product runs on tensor cores in three TF32 passes: a producer warpgroup
copies the raw tiles, and two consumer warpgroups that take turns at the
tensor cores split each B operand into hi and lo planes once and build
each A operand in registers.  Unlike the Pallas kernel
the forward also takes an initial state and returns the final one, so the
model's ``ssd_chunked`` maps onto it whole.

``SSDScanFunction`` makes the kernel differentiable: its forward launches
the forward kernel and keeps the scratch the backward reuses (the f64
cumulative sums, the scores C.B^T and the states entering each chunk);
its backward launches the backward kernel on them, for both outputs (y and
the final state) and for h0 when it was given.  The backward runs dW = dy
x^T once a head and tile pair, takes R's row sums and E's column sums
from the same products, and sums dG over the heads before its products
with B and C.  The gradients are deterministic (no atomics).  A
failed build or launch raises in either; nothing falls back to the plain
version.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:26"
BWD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
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

    def __call__(self, x, dt, A, B, C, chunk: int = 256, h0=None,
                 keep: bool = False):
        """x: (b, s, h, p) float32 or bfloat16; dt: (b, s, h) and A: (h,)
        float32; B, C: (b, s, n) in x's dtype; ``chunk`` <= 256 divides s;
        h0: optional (b, h, n, p) float32 initial state.  Contiguous, on one
        CUDA device.  Returns (y (b, s, h, p), final_state (b, h, n, p)),
        both float32; with ``keep``, (y, final_state, scratch): the f64
        cumulative sums, the scores and the entering states, which the
        backward reads; it raises first, before any launch, if the
        backward kernel has no entry for this head_dim and d_state."""
        _check(x, dt, A, B, C, chunk, h0, "ssd_scan")
        b, s, h, p = x.shape
        n = B.shape[-1]
        if keep:
            ssd_scan_bwd.require_built(p, n)

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
        if keep:
            return y, final, (cum, scores, states)
        return y, final


def _check(x, dt, A, B, C, chunk, h0, what):
    """The argument checks the forward and backward kernels share."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {x.device}")
    if (x.dtype not in _DTYPES or B.dtype != x.dtype
            or C.dtype != x.dtype or dt.dtype != torch.float32
            or A.dtype != torch.float32
            or (h0 is not None and h0.dtype != torch.float32)):
        raise ValueError(
            f"{what}: dtypes x {x.dtype} B {B.dtype} C {C.dtype} dt "
            f"{dt.dtype} A {A.dtype}; x, B and C need one of "
            f"{sorted(map(str, _DTYPES))}, dt, A and h0 float32")
    if x.dim() != 4:
        raise ValueError(f"{what}: bad shape x {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1] if B.dim() == 3 else -1
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n)
            or C.shape != B.shape
            or (h0 is not None and h0.shape != (b, h, n, p))
            or not 1 <= b <= _MAX_GRID or not 1 <= h <= _MAX_GRID
            or not 1 <= s <= _INT_MAX):
        raise ValueError(
            f"{what}: bad shapes x {tuple(x.shape)} dt "
            f"{tuple(dt.shape)} A {tuple(A.shape)} B {tuple(B.shape)} C "
            f"{tuple(C.shape)} h0 "
            f"{None if h0 is None else tuple(h0.shape)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {p} not in {HEAD_DIMS}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"{what}: d_state {n} not in 1..{MAX_STATE}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"{what}: chunk {chunk} must be in "
                         f"1..{MAX_CHUNK} and divide s = {s}")
    tensors = [x, dt, A, B, C] + ([] if h0 is None else [h0])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")


ssd_scan = SSDScan()


class SSDScanBwd:
    """``(x, dt, A, B, C, h0, scratch, grad_y, grad_final, chunk) -> (dx,
    ddt, dA, dB, dC, dh0)`` on the card, counting launches; each call
    launches six CUDA kernels in order on the current stream: local
    states, state passing backwards, dx (with the entering state's term, E's
    column sums and V), dG (summed over the heads, and R's row sums), dt,
    and the sums (dB, dC once for all heads, and dA)."""

    name = "ssd_scan_bwd"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._lib = self._fn = None

    def _kernel(self):
        if self._fn is None:
            lib = build.load(self.name)
            fn = lib.repro_ssd_scan_bwd
            fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.repro_ssd_bwd_scratch.argtypes = [ctypes.c_int] * 7
            lib.repro_ssd_bwd_scratch.restype = ctypes.c_longlong
            lib.repro_ssd_bwd_built.argtypes = [ctypes.c_int] * 2
            lib.repro_ssd_bwd_built.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def require_built(self, p: int, n: int):
        """Raise unless the library holds an entry for head_dim ``p`` and
        d_state ``n``: it is built for the port's models' and tests' shapes
        only (``repro_ssd_bwd_built``)."""
        self._kernel()
        if not self._lib.repro_ssd_bwd_built(p, n):
            raise ValueError(f"{self.name}: no kernel built for head_dim "
                             f"{p} and d_state {n}")

    def mark_launches(self, events=None):
        """``build.mark_launches`` for this library's six launches."""
        self._kernel()
        self._marks = build.mark_launches(
            self._lib.repro_ssd_bwd_mark_launches, events, 6, self.name)

    def __call__(self, x, dt, A, B, C, h0, scratch, grad_y, grad_final,
                 chunk: int = 256):
        """x, dt, A, B, C, h0 and ``chunk`` as the forward took them;
        ``scratch`` the forward's with ``keep``; grad_y (b, s, h, p) and
        grad_final (b, h, n, p) float32, contiguous.  Returns dx, dB, dC
        in x's dtype, ddt (b, s, h), dA (h,) and dh0 (None without h0)
        float32."""
        what = "ssd_scan_bwd"
        _check(x, dt, A, B, C, chunk, h0, what)
        b, s, h, p = x.shape
        n = B.shape[-1]
        nc = s // chunk
        cum, scores, states = scratch
        for name, t, shape, dtype in (
                ("grad_y", grad_y, (b, s, h, p), torch.float32),
                ("grad_final", grad_final, (b, h, n, p), torch.float32),
                ("cum", cum, (b, s, h), torch.float64),
                ("scores", scores, (b, nc, chunk, chunk), torch.float32),
                ("states", states, (b, nc, h, n, p), torch.float32)):
            if (t.shape != shape or t.dtype != dtype or t.device != x.device
                    or not t.is_contiguous()):
                raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype}"
                                 f" must be contiguous {dtype} {shape} on "
                                 f"{x.device}")

        fn = self._kernel()
        dev = x.device
        dx = torch.empty_like(x)
        dB, dC = torch.empty_like(B), torch.empty_like(C)
        ddt = torch.empty((b, s, h), dtype=torch.float32, device=dev)
        dA = torch.empty((h,), dtype=torch.float32, device=dev)
        dh0 = None if h0 is None else torch.empty_like(h0)
        # scratch, written before it is read: dS' of every chunk, <S, dS'>
        # per chunk, two per-step terms of d.cum (the entering state's, V),
        # R's row sums and E's column sums a tile pair, dG summed over the
        # heads a tile pair, and dt . d.a per chunk
        scratch = [torch.empty(
            (self._lib.repro_ssd_bwd_scratch(which, b, s, h, p, n, chunk),),
            dtype=torch.float32, device=dev) for which in range(7)]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(*(t.data_ptr() for t in (
                x, dt, A, B, C, cum, scores, states, grad_y, grad_final, dx,
                ddt, dA, dB, dC)), None if dh0 is None else dh0.data_ptr(),
                *(t.data_ptr() for t in scratch),
                b, s, h, p, n, chunk, _DTYPES[x.dtype], stream)
        build.check(self._lib, code, "ssd_scan_bwd launch")
        with self._lock:
            self.launches += 1
        return dx, ddt, dA, dB, dC, dh0


ssd_scan_bwd = SSDScanBwd()


class SSDScanFunction(torch.autograd.Function):
    """``apply(x, dt, A, B, C, h0, chunk) -> (y, final_state)``: the
    forward kernel (counted), keeping its scratch, and a backward that
    launches the backward kernel (counted) and returns the gradients with
    respect to x, dt, A, B, C and h0 (None when h0 was None), each only
    where the input needs it.  A failed build or launch raises in
    either."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0, chunk):
        y, final, scratch = ssd_scan(x, dt, A, B, C, chunk, h0, keep=True)
        ctx.save_for_backward(x, dt, A, B, C, h0, *scratch)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, grad_y, grad_final):
        needs = ctx.needs_input_grad[:6]
        x, dt, A, B, C, h0, *scratch = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, A, B, C, h0, scratch,
                             grad_y.contiguous(), grad_final.contiguous(),
                             ctx.chunk)
        dx, ddt, dA, dB, dC, dh0 = grads
        return tuple(g if need else None for g, need in zip(
            (dx, ddt, dA, dB, dC, dh0), needs)) + (None,)
