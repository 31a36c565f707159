"""Flash attention: the wrappers of the CUDA kernels in
``csrc/flash_attention.cu`` (the forward, which replaces the Pallas TPU
kernel ``repro/kernels/flash_attention.py``) and
``csrc/flash_attention_bwd.cu`` (its backward).

The wrappers take CUDA tensors only; ``ops.flash_attention`` sends CPU
tensors to the plain version in ``ref.py``.  ``flash_attention.launches``
and ``flash_attention_bwd.launches`` count each kernel's calls, so a run
can show that its attention, and its training's gradients, went through
the kernels.

The kernel has two routes, chosen by dtype and head dim alone (``route``),
with no fallback between them: bfloat16 runs on ``wgmma`` with TMA loads
(one bf16 tensor-core pass, f32 softmax); float32 on three TF32
tensor-core passes (f32-accurate), by ``mma.sync`` below head dim 128 and
at 128 by ``wgmma`` with each operand split into its TF32 halves once.
TMA reads the bf16 inputs through tensor maps, which need 16-byte aligned
bases and strides: an unaligned bf16 view raises, it is not copied.

``FlashAttentionFunction`` makes the kernel differentiable: its forward
launches the forward kernel, which also writes the rows' log-sum-exp, and
saves q, k, v, the output and the log-sum-exp; its backward launches the
backward kernel (FlashAttention-2's five products on ``wgmma``: blocks over
key tiles, dQ's parts added in the order of the key tiles; deterministic,
with no float atomics) on them.  A failed build or launch
raises in either; nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:28"
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 65535          # the grid's y (heads) and z (batch) extents
_INT_MAX = 2 ** 31 - 1
_TMA_ALIGN = 16            # bytes, of a tensor map's base and strides


def route(dtype, head_dim: int) -> str:
    """The kernel route a call with this dtype and head dim takes."""
    if dtype == torch.bfloat16:
        return "wgmma_tma_bf16"
    return "tf32x3_split_once" if head_dim == 128 else "tf32x3"


def _tma_aligned(t) -> bool:
    """Whether TMA can read ``t`` (b, heads, s, d): a 16-byte aligned base,
    and 16-byte strides wherever a dimension is stepped."""
    size = t.element_size()
    return t.data_ptr() % _TMA_ALIGN == 0 and all(
        t.stride(i) * size % _TMA_ALIGN == 0
        for i in range(3) if t.shape[i] > 1)


class FlashAttention:
    """``(q, k, v) -> out`` on the card, counting launches."""

    name = "flash_attention"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._lib = self._fn = None

    def _kernel(self):
        if self._fn is None:
            lib = build.load(self.name)
            fn = lib.repro_flash_attention
            fn.argtypes = ([ctypes.c_void_p] * 5
                           + [ctypes.POINTER(ctypes.c_longlong)]
                           + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.repro_flash_smem_bytes.argtypes = [ctypes.c_int] * 2
            lib.repro_flash_smem_bytes.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def smem_bytes(self, dtype, head_dim: int) -> int:
        """The dynamic shared memory one launch of this dtype and head dim
        takes (builds the library if needed)."""
        self._kernel()
        return self._lib.repro_flash_smem_bytes(_DTYPES[dtype], head_dim)

    def __call__(self, q, k, v, causal: bool = True, window=None,
                 with_lse: bool = False):
        """q: (b, h, sq, d); k, v: (b, kv, sk, d), kv dividing h; one dtype
        (float32 or bfloat16), each with its last dimension contiguous (any
        strides elsewhere: the model passes transposed views of its
        (b, s, heads, d) tensors), on one CUDA device.  ``window`` (>= 1)
        applies only with ``causal``.  Returns (b, h, sq, d) in q's dtype,
        a transposed view of a (b, sq, h, d) tensor, the model's order;
        with ``with_lse``, (out, lse): the rows' log-sum-exp (b, h, sq)
        float32, which the backward reads."""
        _check(q, k, v, window, "flash_attention")
        if q.dtype == torch.bfloat16 and not all(
                map(_tma_aligned, (q, k, v))):
            raise ValueError("flash_attention: bfloat16 q, k and v need "
                             "16-byte aligned bases and strides (TMA)")
        b, h, sq, d = q.shape
        _, kv, sk, _ = k.shape

        fn = self._kernel()
        out = torch.empty((b, sq, h, d), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
               if with_lse else None)
        strides = (ctypes.c_longlong * 12)(
            *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None if lse is None else lse.data_ptr(),
                      strides, b, h, kv, sq, sk, d, int(bool(causal)),
                      int(window or 0), _DTYPES[q.dtype], d ** -0.5, stream)
        build.check(self._lib, code, "flash_attention launch")
        with self._lock:
            self.launches += 1
        return (out, lse) if with_lse else out


def _check(q, k, v, window, what):
    """The argument checks the forward and backward kernels share."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: dtypes {q.dtype} {k.dtype} {v.dtype}; "
                         f"need one of {sorted(map(str, _DTYPES))}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    _, kv, sk, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != d or kv < 1 or h % kv
            or not 1 <= b <= _MAX_GRID or not 1 <= h <= _MAX_GRID
            or not 1 <= sq <= _INT_MAX or not 1 <= sk <= _INT_MAX):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in {HEAD_DIMS}")
    if window is not None and not 1 <= window <= _INT_MAX:
        raise ValueError(f"{what}: window {window} < 1")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: tensors on different devices")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{what}: the last dimension of q, k and v must be "
                         "contiguous")


flash_attention = FlashAttention()


class FlashAttentionBwd:
    """``(q, k, v, out, lse, grad_out) -> (dq, dk, dv)`` on the card,
    counting launches; each call launches three CUDA kernels in order on
    the current stream: the rows' D and lse; the main kernel, whose blocks
    each own a key tile and form S and dP once a (query tile, key tile,
    head) for dV, dK and dQ's part, added to an f32 sum in the order of
    the key tiles; dQ, scaled and converted."""

    name = "flash_attention_bwd"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._lib = self._fn = None

    def _kernel(self):
        if self._fn is None:
            lib = build.load(self.name)
            fn = lib.repro_flash_attention_bwd
            fn.argtypes = ([ctypes.c_void_p] * 12
                           + [ctypes.POINTER(ctypes.c_longlong)]
                           + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.repro_flash_bwd_sync_ints.argtypes = [ctypes.c_int] * 3
            lib.repro_flash_bwd_sync_ints.restype = ctypes.c_longlong
            self._lib, self._fn = lib, fn
        return self._fn

    def mark_launches(self, events=None):
        """``build.mark_launches`` for this library's three launches."""
        self._kernel()
        self._marks = build.mark_launches(
            self._lib.repro_flash_bwd_mark_launches, events, 3, self.name)

    def __call__(self, q, k, v, out, lse, grad_out, causal: bool = True,
                 window=None):
        """q, k, v as the forward takes them; out and grad_out (b, h, sq,
        d) in q's dtype with their last dimension contiguous; lse (b, h,
        sq) float32, contiguous, from the forward with ``with_lse``.
        Returns (dq, dk, dv) in q's dtype, each a transposed view of a
        (b, s, heads, d) tensor, the model's order."""
        what = "flash_attention_bwd"
        _check(q, k, v, window, what)
        b, h, sq, d = q.shape
        _, kv, sk, _ = k.shape
        for name, t in (("out", out), ("grad_out", grad_out)):
            if (t.shape != q.shape or t.dtype != q.dtype
                    or t.device != q.device or t.stride(3) != 1):
                raise ValueError(f"{what}: {name} {tuple(t.shape)} "
                                 f"{t.dtype} on {t.device} must match q "
                                 f"with its last dimension contiguous")
        if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
                or lse.device != q.device or not lse.is_contiguous()):
            raise ValueError(f"{what}: lse {tuple(lse.shape)} {lse.dtype} "
                             f"must be contiguous float32 (b, h, sq) on "
                             f"{q.device}")

        fn = self._kernel()
        dq = torch.empty((b, sq, h, d), dtype=q.dtype,
                         device=q.device).transpose(1, 2)
        dk, dv = (torch.empty((b, sk, kv, d), dtype=q.dtype,
                              device=q.device).transpose(1, 2)
                  for _ in range(2))
        # scratch, written before it is read: each row's lse in log2 units
        # and D = rowsum(grad_out * out); dQ's f32 sum over the key tiles;
        # the work ticket and one counter a (batch row, head, query tile)
        rows = torch.empty((2, b, h, sq), dtype=torch.float32,
                           device=q.device)
        dq_acc = torch.empty((b, h, sq, d), dtype=torch.float32,
                             device=q.device)
        sync = torch.empty((self._lib.repro_flash_bwd_sync_ints(b, h, sq),),
                           dtype=torch.int32, device=q.device)
        strides = (ctypes.c_longlong * 24)(
            *(t.stride(i) for t in (q, k, v, out, grad_out, dq, dk, dv)
              for i in range(3)))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      rows.data_ptr(), dq_acc.data_ptr(), sync.data_ptr(),
                      strides, b, h, kv, sq, sk, d,
                      int(bool(causal)), int(window or 0), _DTYPES[q.dtype],
                      d ** -0.5, stream)
        build.check(self._lib, code, "flash_attention_bwd launch")
        with self._lock:
            self.launches += 1
        return dq, dk, dv


flash_attention_bwd = FlashAttentionBwd()


class FlashAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, causal, window)``: the forward kernel (counted),
    which also writes the rows' log-sum-exp, and a backward that launches
    the backward kernel (counted) on the saved q, k, v, output and
    log-sum-exp.  Gradients come back only for the inputs that need them.
    A failed build or launch raises in either."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[:3]
        q, k, v, out, lse = ctx.saved_tensors
        if grad_out.stride(3) != 1:
            grad_out = grad_out.contiguous()
        grads = flash_attention_bwd(q, k, v, out, lse, grad_out, ctx.causal,
                                    ctx.window)
        return tuple(g if need else None for g, need in zip(grads, needs)) + (
            None, None)
