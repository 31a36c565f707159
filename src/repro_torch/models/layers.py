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

from repro_torch.sharding import distributed, shard


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
    h = shard(F.silu(h) * u, "batch", "seq", "ff")
    return torch.einsum("...f,fd->...d", h, params["w_down"])


# ---------------------------------------------------------------- Embedding
def embed_init(generator, vocab, d_model, device="cuda", dtype=torch.float32):
    return {"table": truncated_normal(generator, (vocab, d_model), 1.0,
                                      device, dtype)}


def embed(params, tokens):
    """The table's rows at ``tokens``; a DTensor table under sharding rules
    takes ``_sharded_embed``."""
    table = params["table"]
    if distributed(table):
        return _sharded_embed(table, tokens)
    return table[tokens]


def _sharded_embed(table, tokens):
    """The lookup on a DTensor table as the JAX package's partitioner does
    it, without gathering the table: each rank looks up the rows its shard
    holds and zeros the rest.  For each mesh dim:

    * the table sharded on vocab: every rank takes all the tokens, and the
      rows are a partial sum, which the next layout hint reduces; the
      table's gradient stays a vocab shard (DTensor's own rule for this
      lookup leaves a masked partial sum in the gradient, which a tied
      unembedding's partial sum cannot be added to);
    * sharded on d_model: the rows are sharded on d_model as well;
    * replicated: the rows are placed as the tokens are, and the table's
      gradient is a partial sum over a dim that shards the tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = table.device_mesh
    token_pl, out_pl, grad_pl = [], [], []
    for tp, xp in zip(table.placements, tokens.placements):
        if tp.is_shard():
            token_pl.append(Replicate())
            out_pl.append(Partial() if tp.dim == 0 else Shard(tokens.ndim))
            grad_pl.append(tp)
        else:
            token_pl.append(xp)
            out_pl.append(xp)
            grad_pl.append(Partial() if xp.is_shard() else Replicate())
    ids = tokens.redistribute(mesh, token_pl).to_local()
    local = table.to_local(grad_placements=grad_pl)
    _, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    ids = ids - offset[0]
    hit = (ids >= 0) & (ids < local.shape[0])
    rows = F.embedding(torch.where(hit, ids, 0), local)
    rows = rows.masked_fill(~hit[..., None], 0)
    shape = (*tokens.shape, table.shape[1])
    stride = [1]
    for d in reversed(shape[1:]):
        stride.insert(0, stride[0] * d)
    return DTensor.from_local(rows, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


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
        # under sharding rules a vocab-sharded gather is a partial sum
        # whose mask has the gather's shape: resolve it before the index
        ll = shard(torch.gather(logits, -1, lc[..., None]),
                   "batch", None, None)[..., 0]
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
