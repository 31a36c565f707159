"""Single-token decode attention: the wrapper of the CUDA kernel in
``csrc/decode_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py``.

The wrapper takes CUDA tensors only; ``ops.decode_attention`` sends CPU
tensors to the plain version in ``ref.py``.  ``decode_attention.launches``
counts the wrapper's calls that launched the kernel, so a run can show
that its decode steps went through it.

A call is one CUDA launch when ``plan_splits`` cuts the cache into at most
``CLUSTER_MAX`` key ranges: the ranges of a (row, KV head) are one
thread-block cluster and merge through distributed shared memory.  A plan
of more ranges (a cache far longer than the batch's blocks can cover)
merges their partial results in a second launch.  That routing is by shape
alone (``kernel_names``).  bfloat16 queries over a bfloat16 cache run on
tensor cores (``decode_mma_kernel``); float32 queries on CUDA cores
(``decode_split_kernel``), f32-accurate.

K and V are read in their own dtype: a bfloat16 decode cache under float32
queries (``transformer.init_cache``'s default under float32 params) is
widened inside the kernel, never copied.
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
# (q's dtype, K's and V's): same dtypes, or a bf16 cache under f32 queries
PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.bfloat16))
_MAX_ROWS = 65535          # the grid's y extent
TILE_ELEMS = 4096          # kTileElems in csrc/decode_attention.cu
SMS = 132                  # streaming multiprocessors of an H100 SXM
CLUSTER_MAX = 8            # kClusterMax: key ranges a cluster merges
# The blocks a plan aims at, by route: the most that stay one wave once a
# cluster's blocks must sit together, at the route's work a key.  The
# tensor-core route is cheap a key, so it wants few long ranges; the
# CUDA-core route over an f32 cache (73 KB of shared memory a block) more;
# over a bf16 cache (41 KB) most.  Read off `scripts/decode_plan_sweep.py`
# at the zoo's serving shapes on an H100 (PERF.md).
TARGET_BLOCKS = {"mma": SMS + SMS // 2, "cuda_f32_cache": 5 * SMS // 2,
                 "cuda_bf16_cache": 4 * SMS}


def route(q_dtype, kv_dtype=None) -> str:
    """The block kernel's route for these dtypes: tensor cores for bfloat16
    queries (over a bfloat16 cache), CUDA cores for float32 queries over
    either cache."""
    kv_dtype = kv_dtype or q_dtype
    if q_dtype == torch.bfloat16:
        return "mma"
    return ("cuda_bf16_cache" if kv_dtype == torch.bfloat16
            else "cuda_f32_cache")


def plan_splits(b: int, kv: int, s: int, d: int, q_dtype=torch.float32,
                kv_dtype=None):
    """``(splits, keys_per_split)``: how the kernel cuts the cache axis.

    From the shapes and dtypes alone, never from ``lengths``, so a call
    adds no sync with the device.  Each split is a whole number of key
    tiles (``TILE_ELEMS // d`` keys), none is empty, and together they
    cover the ``s`` keys: as many splits as keep ``splits * b * kv``
    blocks within the route's target (``TARGET_BLOCKS``), at least one.
    Up to ``CLUSTER_MAX`` splits merge inside one cluster (one launch);
    more take the combine launch (``kernel_names``).  Where the target
    allows at most twice a cluster's splits (every serving shape), the
    plan stops at one cluster."""
    tile = TILE_ELEMS // d
    tiles = -(-s // tile)
    wanted = max(1, TARGET_BLOCKS[route(q_dtype, kv_dtype)] // (b * kv))
    if wanted <= 2 * CLUSTER_MAX:
        wanted = min(wanted, CLUSTER_MAX)
    per_split = -(-tiles // min(wanted, tiles))
    return -(-tiles // per_split), per_split * tile


def kernel_names(q_dtype, kv_dtype, b: int, kv: int, s: int, d: int):
    """The CUDA kernels one call launches, in order, from the shapes and
    dtypes alone: the block kernel (tensor cores for bfloat16 q, CUDA cores
    for float32 q), then the combine kernel when the plan has more splits
    than a cluster holds."""
    first = ("decode_mma_kernel" if route(q_dtype, kv_dtype) == "mma"
             else "decode_split_kernel")
    splits = plan_splits(b, kv, s, d, q_dtype, kv_dtype)[0]
    return [first] + (["decode_combine_kernel"] if splits > CLUSTER_MAX
                      else [])


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
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, q, k, v, lengths):
        """q: (b, h, d); k, v: (b, s, kv, d), kv dividing h; lengths: (b,)
        int32.  (q, K/V) dtypes: one of ``PAIRS``; K and V are read as they
        are.  Returns (b, h, d) in q's dtype."""
        if q.device.type != "cuda":
            raise ValueError(
                f"decode_attention kernel needs CUDA tensors, got {q.device}")
        if k.dtype != v.dtype or (q.dtype, k.dtype) not in PAIRS:
            raise ValueError(f"decode_attention: dtypes q {q.dtype}, k "
                             f"{k.dtype}, v {v.dtype}; supported (q, k/v): "
                             f"{[(str(a), str(b)) for a, b in PAIRS]}")
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
        splits, keys_per_split = plan_splits(b, kv, s, d, q.dtype, k.dtype)
        out = torch.empty_like(q)
        # past a cluster, the splits' partial (m, l) and accumulators,
        # merged by the second launch; from the caching allocator, so a
        # CUDA graph captures it
        part = (torch.empty(splits * b * h * (d + 2), dtype=torch.float32,
                            device=q.device) if splits > CLUSTER_MAX
                else None)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lengths.data_ptr(), out.data_ptr(),
                      part.data_ptr() if part is not None else None, b, h, s,
                      kv, d, _DTYPES[q.dtype], _DTYPES[k.dtype], splits,
                      keys_per_split, d ** -0.5, stream)
        build.check(self._lib, code, "decode_attention launch")
        with self._lock:
            self.launches += 1
        return out


decode_attention = DecodeAttention()
