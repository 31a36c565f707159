"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060), forward
half.

Prefill and scoring use the chunked SSD algorithm: quadratic
attention-like compute *within* fixed-size chunks plus a linear recurrence
*across* chunk states.  ``ssd_chunked`` calls ``ops.ssd_scan``: the CUDA
SSD kernel on CUDA tensors, its plain version (``kernels/ref.py``, the
port of the JAX package's jnp ``ssd_chunked``) on CPU tensors.

Head layout follows Mamba2: d_inner = expand*d_model split into H heads of
P=head_dim channels; B and C are shared across heads (single group, like
MQA); per-head scalar dt and A.

The one-token decode half (``init_ssm_cache``, ``ssm_step``) comes with
the slice that serves SSM and hybrid models token by token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig


def ssm_init(generator, cfg: ArchConfig, device="cuda", dtype=torch.float32):
    s, d = cfg.ssm, cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    n = s.d_state
    conv_dim = di + 2 * n                       # x + B + C go through the conv
    in_proj = layers.truncated_normal(generator, (d, 2 * di + 2 * n + nh),
                                      d ** -0.5, device, dtype)
    conv_w = layers.truncated_normal(generator, (s.conv_width, conv_dim), 0.1,
                                     device, dtype)
    u = torch.rand((nh,), generator=generator)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    out_proj = layers.truncated_normal(generator, (di, d), di ** -0.5, device,
                                       dtype)
    return {
        # order: [z (di), x (di), B (n), C (n), dt (nh)]
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), device=device, dtype=dtype),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32)
                           ).to(device),
        "dt_bias": torch.log(torch.expm1(dt)).to(device),
        "D": torch.ones((nh,), device=device, dtype=torch.float32),
        "norm": layers.rmsnorm_init(di, device, dtype),
        "out_proj": out_proj,
    }


def _split_proj(cfg: ArchConfig, proj):
    s = cfg.ssm
    di, n = s.d_inner(cfg.d_model), s.d_state
    nh = s.num_heads(cfg.d_model)
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, nh], dim=-1)
    return z, xbc, dt


def _causal_conv(w, b, xbc):
    """Depthwise causal conv over (b, s, c) plus SiLU: out[t] =
    sum_i w[i] * xbc[t - (width - 1) + i], zeros before the start.

    Written as ``width`` shifted multiply-adds, not ``F.conv1d``: on CUDA a
    float32 convolution goes to cuDNN, which runs it in TF32 unless the
    caller has turned that off."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    w = w.to(xbc.dtype)
    out = pad[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b.to(out.dtype))


def ssd_chunked(xh, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD scan.

    xh: (b, s, h, p)   per-head inputs
    dt: (b, s, h)      softplus'd step sizes (>0)
    A:  (h,)           negative per-head decay rates
    B:  (b, s, n)      input projection (single group)
    C:  (b, s, n)      output projection
    h0: optional (b, h, n, p) state entering the first chunk
    Returns (y: (b, s, h, p) float32, final_state: (b, h, n, p) float32).
    """
    s = xh.shape[1]
    assert s % chunk == 0, (s, chunk)
    return ops.ssd_scan(xh.contiguous(), dt.float().contiguous(),
                        A.float().contiguous(), B.contiguous(),
                        C.contiguous(), chunk=chunk,
                        h0=None if h0 is None else h0.float().contiguous())


def ssm_forward(params, cfg: ArchConfig, x):
    """Full-sequence Mamba2 block. x: (b, s, d) -> (y, final_state)."""
    s_cfg = cfg.ssm
    di = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.num_heads(cfg.d_model)
    n, p = s_cfg.d_state, s_cfg.head_dim

    proj = torch.einsum("bsd,de->bse", x, params["in_proj"])
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc = _causal_conv(params["conv_w"], params["conv_b"], xbc)
    xi, B, C = torch.split(xbc, [di, n, n], dim=-1)
    xh = xi.reshape(*xi.shape[:2], nh, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    y, final = ssd_chunked(xh, dt, A, B, C, min(s_cfg.chunk_size, x.shape[1]))
    y = y + xh.float() * params["D"][None, None, :, None]
    y = y.reshape(*x.shape[:2], di).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y * F.silu(z), cfg.rmsnorm_eps)
    return torch.einsum("bsi,id->bsd", y, params["out_proj"]), final
