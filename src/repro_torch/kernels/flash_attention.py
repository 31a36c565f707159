"""Flash attention (forward): the wrapper of the CUDA kernel in
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py``.

The wrapper takes CUDA tensors only; ``ops.flash_attention`` sends CPU
tensors to the plain version in ``ref.py``.  ``flash_attention.launches``
counts the kernel's launches, so a run can show that its attention went
through the kernel.

The kernel has two routes, chosen by dtype and head dim alone (``route``),
with no fallback between them: bfloat16 runs on ``wgmma`` with TMA loads
(one bf16 tensor-core pass, f32 softmax); float32 on three TF32
tensor-core passes (f32-accurate), by ``mma.sync`` below head dim 128 and
at 128 by ``wgmma`` with each operand split into its TF32 halves once.
TMA reads the bf16 inputs through tensor maps, which need 16-byte aligned
bases and strides: an unaligned bf16 view raises, it is not copied.

The kernel computes the forward pass only.  ``FlashAttentionFunction``
makes it differentiable: its forward launches the kernel, and its backward
recomputes the attention through the plain version and differentiates
that.  The recompute is the correctness route, not a design (a backward
kernel is still to be written); it launches no kernel, so ``launches``
counts forward launches only.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:28"
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
            fn.argtypes = ([ctypes.c_void_p] * 4
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

    def __call__(self, q, k, v, causal: bool = True, window=None):
        """q: (b, h, sq, d); k, v: (b, kv, sk, d), kv dividing h; one dtype
        (float32 or bfloat16), each with its last dimension contiguous (any
        strides elsewhere: the model passes transposed views of its
        (b, s, heads, d) tensors), on one CUDA device.  ``window`` (>= 1)
        applies only with ``causal``.  Returns (b, h, sq, d) in q's dtype,
        a transposed view of a (b, sq, h, d) tensor, the model's order."""
        if q.device.type != "cuda":
            raise ValueError(
                f"flash_attention kernel needs CUDA tensors, got {q.device}")
        if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError(f"flash_attention: dtypes {q.dtype} {k.dtype} "
                             f"{v.dtype}; need one of "
                             f"{sorted(map(str, _DTYPES))}")
        if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
            raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}"
                             f" k {tuple(k.shape)} v {tuple(v.shape)}")
        b, h, sq, d = q.shape
        _, kv, sk, _ = k.shape
        if (k.shape[0] != b or k.shape[3] != d or kv < 1 or h % kv
                or not 1 <= b <= _MAX_GRID or not 1 <= h <= _MAX_GRID
                or not 1 <= sq <= _INT_MAX or not 1 <= sk <= _INT_MAX):
            raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}"
                             f" k {tuple(k.shape)}")
        if d not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head_dim {d} not in "
                             f"{HEAD_DIMS}")
        if window is not None and not 1 <= window <= _INT_MAX:
            raise ValueError(f"flash_attention: window {window} < 1")
        if k.device != q.device or v.device != q.device:
            raise ValueError("flash_attention: tensors on different devices")
        if any(t.stride(3) != 1 for t in (q, k, v)):
            raise ValueError("flash_attention: the last dimension of q, k "
                             "and v must be contiguous")
        if q.dtype == torch.bfloat16 and not all(
                map(_tma_aligned, (q, k, v))):
            raise ValueError("flash_attention: bfloat16 q, k and v need "
                             "16-byte aligned bases and strides (TMA)")

        fn = self._kernel()
        out = torch.empty((b, sq, h, d), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        strides = (ctypes.c_longlong * 12)(
            *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), strides, b, h, kv, sq, sk, d,
                      int(bool(causal)), int(window or 0), _DTYPES[q.dtype],
                      d ** -0.5, stream)
        build.check(self._lib, code, "flash_attention launch")
        with self._lock:
            self.launches += 1
        return out


flash_attention = FlashAttention()


class FlashAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, causal, window)``: the kernel's forward (counted),
    and a backward that recomputes the plain version from the saved inputs
    and returns its gradients.  A failed build or launch in the forward
    raises, as without autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out = ref.flash_attention_ref(*inputs, causal=ctx.causal,
                                          window=ctx.window)
            grads = iter(torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], grad_out))
        return tuple(next(grads) if need else None for need in needs) + (
            None, None)
