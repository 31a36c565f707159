"""Shared neural-net building blocks (plain functions over dicts of tensors).

Parameters keep the JAX package's leaf names and layouts (dense weights are
``(in, out)``), so weights carry across name for name.  Initializers draw
from an explicit CPU ``torch.Generator`` and then move to ``device``, so one
seed gives the same weights on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def truncated_normal(generator, shape, stddev, device="cuda",
                     dtype=torch.float32):
    x = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (stddev * x).to(device=device, dtype=dtype)


def dense_init(generator, d_in, d_out, device="cuda", dtype=torch.float32):
    return truncated_normal(generator, (d_in, d_out), d_in ** -0.5, device,
                            dtype)


# ---------------------------------------------------------------- RMSNorm
def rmsnorm_init(d, device="cuda", dtype=torch.float32):
    return {"scale": torch.ones((d,), device=device, dtype=dtype)}


def rmsnorm(params, x, eps=1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def head_rmsnorm(scale, x, eps=1e-6):
    """RMSNorm over the last (head_dim) axis, per head — Qwen3 qk-norm."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device="cuda"):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Half-split
    rotation: the first and second halves of head_dim are the pair."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., seq, hd/2)
    angles = angles[..., None, :]                           # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- SwiGLU MLP
def mlp_init(generator, d_model, d_ff, device="cuda", dtype=torch.float32):
    return {
        "w_gate": dense_init(generator, d_model, d_ff, device, dtype),
        "w_up": dense_init(generator, d_model, d_ff, device, dtype),
        "w_down": dense_init(generator, d_ff, d_model, device, dtype),
    }


def mlp(params, x):
    h = torch.einsum("...d,df->...f", x, params["w_gate"])
    u = torch.einsum("...d,df->...f", x, params["w_up"])
    return torch.einsum("...f,fd->...d", F.silu(h) * u, params["w_down"])


# ---------------------------------------------------------------- Embedding
def embed_init(generator, vocab, d_model, device="cuda", dtype=torch.float32):
    return {"table": truncated_normal(generator, (vocab, d_model), 1.0,
                                      device, dtype)}


def embed(params, tokens):
    return params["table"][tokens]


def unembed(table, x):
    return torch.einsum("...d,vd->...v", x, table)
