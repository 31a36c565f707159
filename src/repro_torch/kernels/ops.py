"""Public kernel entry points, dispatched on the device of their inputs.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the kernel's plain version in ``ref.py``.  There is no
fallback: a kernel that fails to build or launch raises.

Flash attention and the SSD scan are differentiable on the card: when grad
mode is on and an input requires grad, they go through their kernel's
``torch.autograd.Function`` (the kernel forward, a plain recompute
backward).  Otherwise they call the kernel directly, which saves no
inputs for a backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as _decode
from repro_torch.kernels.flash_attention import FlashAttentionFunction
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.ssd_scan import SSDScanFunction
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd
from repro_torch.kernels.vtrace import vtrace as _vtrace


def _on_card(t) -> bool:
    return t.device.type == "cuda"


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (b, h, sq, d); k, v: (b, kv, sk, d), kv dividing h.  ``window``
    applies only with ``causal``."""
    if _on_card(q):
        if _wants_grad(q, k, v):
            return FlashAttentionFunction.apply(q, k, v, causal, window)
        return _flash(q, k, v, causal, window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths):
    """q: (b, h, d); k, v: (b, s, kv, d); lengths: (b,) int32."""
    if _on_card(q):
        return _decode(q, k, v, lengths)
    return ref.decode_attention_ref(q, k, v, lengths)


def ssd_scan(x, dt, A, B, C, *, chunk=256, h0=None):
    """x: (b, s, h, p); dt: (b, s, h); A: (h,); B, C: (b, s, n); h0:
    optional (b, h, n, p).  Returns (y, final_state), both float32."""
    if _on_card(x):
        if _wants_grad(x, dt, A, B, C, h0):
            return SSDScanFunction.apply(x, dt, A, B, C, h0, chunk)
        return _ssd(x, dt, A, B, C, chunk, h0)
    return ref.ssd_scan_ref(x, dt, A, B, C, chunk, h0=h0)


def vtrace(values, next_values, rewards, discounts, rhos, *,
           clip_rho: float = 1.0, clip_c: float = 1.0):
    """Time-major (T, B) float32 inputs.  Returns (vs, pg_advantages)."""
    if _on_card(values):
        return _vtrace(values, next_values, rewards, discounts, rhos,
                       clip_rho, clip_c)
    return ref.vtrace_ref(values, next_values, rewards, discounts, rhos,
                          clip_rho=clip_rho, clip_c=clip_c)
