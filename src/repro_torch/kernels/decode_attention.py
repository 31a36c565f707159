"""Single-token decode attention: the wrapper of the CUDA kernel in
``csrc/decode_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py``.

The wrapper takes CUDA tensors only; ``ops.decode_attention`` sends CPU
tensors to the plain version in ``ref.py``.  ``decode_attention.launches``
counts the kernel's launches, so a run can show that its decode steps went
through the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:27"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 65535          # the grid's y extent


class DecodeAttention:
    """``(q, k, v, lengths) -> out`` on the card, counting launches."""

    name = "decode_attention"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._lib = self._fn = None

    def _kernel(self):
        if self._fn is None:
            lib = build.load(self.name)
            fn = lib.repro_decode_attention
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, q, k, v, lengths):
        """q: (b, h, d); k, v: (b, s, kv, d), kv dividing h; lengths: (b,)
        int32.  K and V are cast to q's dtype first.  Returns (b, h, d) in
        q's dtype."""
        if q.device.type != "cuda":
            raise ValueError(
                f"decode_attention kernel needs CUDA tensors, got {q.device}")
        if q.dtype not in _DTYPES:
            raise ValueError(f"decode_attention: dtype {q.dtype} not in "
                             f"{sorted(map(str, _DTYPES))}")
        k, v = k.to(q.dtype), v.to(q.dtype)
        if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
            raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)}"
                             f" k {tuple(k.shape)} v {tuple(v.shape)}")
        b, h, d = q.shape
        _, s, kv, _ = k.shape
        if (k.shape[0] != b or k.shape[3] != d or kv < 1 or h % kv
                or s < 1 or not 1 <= b <= _MAX_ROWS):
            raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)}"
                             f" k {tuple(k.shape)}")
        if d not in HEAD_DIMS:
            raise ValueError(f"decode_attention: head_dim {d} not in "
                             f"{HEAD_DIMS}")
        if lengths.shape != (b,) or lengths.dtype != torch.int32:
            raise ValueError("decode_attention: lengths must be (b,) int32, "
                             f"got {tuple(lengths.shape)} {lengths.dtype}")
        tensors = (q, k, v, lengths)
        if any(t.device != q.device for t in tensors):
            raise ValueError("decode_attention: tensors on different devices")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("decode_attention: tensors must be contiguous")

        fn = self._kernel()
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lengths.data_ptr(), out.data_ptr(), b, h, s, kv, d,
                      _DTYPES[q.dtype], d ** -0.5, stream)
        build.check(self._lib, code, "decode_attention launch")
        with self._lock:
            self.launches += 1
        return out


decode_attention = DecodeAttention()
