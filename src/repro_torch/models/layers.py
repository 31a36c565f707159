"""Shared neural-net building blocks (plain functions over dicts of tensors).

Parameters keep the JAX package's leaf names and layouts (dense weights are
``(in, out)``), so weights carry across name for name.  Initializers draw
from an explicit ``torch.Generator`` on the generator's own device and then
move to ``device``: a CPU generator gives the same weights on every device,
and a CUDA generator draws a model too large to draw on the host quickly.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def truncated_normal(generator, shape, stddev, device="cuda",
                     dtype=torch.float32):
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
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


def sinusoid_positions(seq_len: int, d_model: int, device="cuda"):
    """(seq_len, d_model) float32: sin at even channels, cos at odd.

    The angles are the JAX package's float32 ones, pos / 10000^(2i/d),
    which XLA computes as pos times the power's reciprocal; the power and
    the sines are taken in float64 and rounded, which agrees with XLA's
    float32 functions to an ulp, where float32 libm calls do not."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    power = torch.pow(10000.0, (dim / d_model).double()).float()
    angle = (pos * (1.0 / power)).double()
    pe = torch.zeros((seq_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle).float()
    pe[:, 1::2] = torch.cos(angle).float()
    return pe


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


def chunked_cross_entropy(x, table, labels, chunk: int = 1024,
                          mask: Optional[torch.Tensor] = None,
                          valid_vocab: Optional[int] = None):
    """Mean next-token CE without materializing full (b, s, V) f32 logits.

    x: (b, s, d) final hidden states; table: (V, d); labels: (b, s) ints.
    Runs over seq chunks (and a remainder chunk); under grad mode each
    chunk's loss goes through ``torch.utils.checkpoint`` (non-reentrant),
    so its logits are recomputed in the backward and live memory is
    O(b * chunk * V).  Vocab entries at or past ``valid_vocab`` get -1e30.
    """
    b, s, _ = x.shape
    chunk = min(chunk, s)
    n = s // chunk
    labels = labels.long()
    mask_f = (torch.ones((b, s), dtype=torch.float32, device=x.device)
              if mask is None else mask.float())

    def chunk_loss(xc, lc, mc):
        logits = unembed(table, xc).float()
        if valid_vocab is not None and valid_vocab < table.shape[0]:
            pad = torch.arange(table.shape[0], device=x.device) >= valid_vocab
            logits = logits.masked_fill(pad, -1e30)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.sum((logz - ll) * mc)

    def loss(lo, hi):
        inputs = (x[:, lo:hi], labels[:, lo:hi], mask_f[:, lo:hi])
        if torch.is_grad_enabled():
            return checkpoint(chunk_loss, *inputs, use_reentrant=False)
        return chunk_loss(*inputs)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        total = total + loss(i * chunk, (i + 1) * chunk)
    if s > n * chunk:
        total = total + loss(n * chunk, s)
    return total / torch.clamp(torch.sum(mask_f), min=1.0)


def cross_entropy(logits, labels, mask: Optional[torch.Tensor] = None):
    """Mean next-token cross entropy in f32. logits (..., V), labels (...,)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
