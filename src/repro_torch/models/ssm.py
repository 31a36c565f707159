"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060).

Prefill and scoring use the chunked SSD algorithm: quadratic
attention-like compute *within* fixed-size chunks plus a linear recurrence
*across* chunk states.  ``ssd_chunked`` calls ``ops.ssd_scan``: the CUDA
SSD kernel on CUDA tensors (three launches a call, on TF32 wgmma; its
backward six), its plain version (``kernels/ref.py``, the port of the JAX
package's jnp ``ssd_chunked``) on CPU tensors.

Head layout follows Mamba2: d_inner = expand*d_model split into H heads of
P=head_dim channels; B and C are shared across heads (single group, like
MQA); per-head scalar dt and A.

Decode runs one token at a time through a constant-size cache
(``init_ssm_cache``, ``ssm_step``): the recurrent state and the last
``conv_width - 1`` conv inputs, updated IN PLACE (the JAX package returns
updated copies); ``ssm_step`` still returns the cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig
from repro_torch.sharding import shard


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
    u = torch.rand((nh,), generator=generator, device=generator.device)
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
    # zeros before the start by a cat, not F.pad, which some torch's
    # DTensor mis-shards
    zeros = torch.zeros_like(xbc[:, :1]).expand(-1, width - 1, -1)
    pad = torch.cat([zeros, xbc], dim=1)
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
    xh = shard(xh, "batch", "seq", "ssm_heads", None)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    y, final = ssd_chunked(xh, dt, A, B, C, min(s_cfg.chunk_size, x.shape[1]))
    y = y + xh.float() * params["D"][None, None, :, None]
    y = y.reshape(*x.shape[:2], di).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y * F.silu(z), cfg.rmsnorm_eps)
    return torch.einsum("bsi,id->bsd", y, params["out_proj"]), final


# ------------------------------------------------------------------ decode
def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                   device="cuda"):
    """One layer's decode cache: ``state`` (b, heads, d_state, head_dim)
    and the rolling conv window ``conv`` (b, conv_width - 1, conv_dim)."""
    s = cfg.ssm
    nh = s.num_heads(cfg.d_model)
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.d_state
    return {
        "state": torch.zeros((batch, nh, s.d_state, s.head_dim), dtype=dtype,
                             device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def ssm_step(params, cfg: ArchConfig, x, cache):
    """One-token decode. x: (b, 1, d).  The conv, softplus, exp and state
    update run in float32; the new state and conv window are written into
    ``cache`` in its dtype.  Returns (y (b, 1, d), cache)."""
    s_cfg = cfg.ssm
    di = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.num_heads(cfg.d_model)
    n, p = s_cfg.d_state, s_cfg.head_dim

    proj = torch.einsum("bsd,de->bse", x, params["in_proj"])
    z, xbc, dt_raw = _split_proj(cfg, proj)

    # rolling conv: window = [cached (w-1), current]
    window = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.float(),
                            params["conv_w"].float())
    xbc1 = F.silu(conv_out + params["conv_b"].float())[:, None, :]
    cache["conv"].copy_(window[:, 1:])

    xi, B, C = torch.split(xbc1, [di, n, n], dim=-1)
    xh = xi.reshape(xi.shape[0], nh, p)                    # (b,h,p)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])  # (b,h)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A[None, :])                         # (b,h)

    h_prev = cache["state"].float()
    Bx = torch.einsum("bn,bhp,bh->bhnp", B[:, 0].float(), xh, dt)
    h_new = h_prev * a[..., None, None] + Bx
    y = torch.einsum("bn,bhnp->bhp", C[:, 0].float(), h_new)
    y = y + xh * params["D"][None, :, None]
    y = y.reshape(x.shape[0], 1, di).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y * F.silu(z), cfg.rmsnorm_eps)
    cache["state"].copy_(h_new)
    return torch.einsum("bsi,id->bsd", y, params["out_proj"]), cache
