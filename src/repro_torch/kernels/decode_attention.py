"""Single-token decode attention: the wrapper of the CUDA kernel in
``csrc/decode_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py``.

The wrapper takes CUDA tensors only; ``ops.decode_attention`` sends CPU
tensors to the plain version in ``ref.py``.  ``decode_attention.launches``
counts the wrapper's calls that launched the kernel, so a run can show
that its decode steps went through it.  A call is one CUDA launch, or two
when ``plan_splits`` cuts the cache into several ranges (the second merges
their partial results).
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
TILE_ELEMS = 4096          # kTileElems in csrc/decode_attention.cu
SMS = 132                  # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 4 * SMS


def plan_splits(b: int, kv: int, s: int, d: int):
    """``(splits, keys_per_split)``: how the kernel cuts the cache axis.

    From the shapes alone, never from ``lengths``, so a call adds no sync
    with the device.  Each split is a whole number of key tiles
    (``TILE_ELEMS // d`` keys), none is empty, and together they cover the
    ``s`` keys.  When ``b * kv`` blocks already fill the card several times
    over (``TARGET_BLOCKS``), or the cache is one tile, there is one split:
    the serving shapes are one launch."""
    tile = TILE_ELEMS // d
    tiles = -(-s // tile)
    wanted = -(-TARGET_BLOCKS // (b * kv))
    per_split = -(-tiles // min(wanted, tiles))
    return -(-tiles // per_split), per_split * tile


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
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
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
        splits, keys_per_split = plan_splits(b, kv, s, d)
        out = torch.empty_like(q)
        # the splits' partial (m, l) and accumulators, merged by the second
        # launch; from the caching allocator, so a CUDA graph captures it
        part = (torch.empty(splits * b * h * (d + 2), dtype=torch.float32,
                            device=q.device) if splits > 1 else None)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lengths.data_ptr(), out.data_ptr(),
                      part.data_ptr() if part is not None else None, b, h, s,
                      kv, d, _DTYPES[q.dtype], splits, keys_per_split,
                      d ** -0.5, stream)
        build.check(self._lib, code, "decode_attention launch")
        with self._lock:
            self.launches += 1
        return out


decode_attention = DecodeAttention()
