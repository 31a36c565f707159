"""Mixture-of-Experts FFN with GShard-style capacity dispatch.

Tokens are bucketed into small groups (``group_size`` tokens each); within
a group each token's top-k experts are assigned a slot in a fixed
per-expert capacity buffer, and dispatch and combine are one-hot einsums.
Assignments claim slots rank-major (every token's first choice before any
token's second), and an assignment past its expert's capacity is dropped.
The router runs in float32 at every param dtype.

Includes the load-balance auxiliary loss (Switch/GShard) and router z-loss.

The JAX package computes the dispatch, combine and expert products as
einsums outside any Pallas kernel, so here they are ``torch.einsum``.  On
the card they are exact 0/1 products only with TF32 off for float32
matmuls (``torch.backends.cuda.matmul.allow_tf32``, off by default).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ArchConfig, MoEConfig
from repro_torch.sharding import shard

GROUP = 256


def moe_init(generator, cfg: ArchConfig, device="cuda", dtype=torch.float32):
    m = cfg.moe
    d, f, n = cfg.d_model, m.d_expert, m.num_experts

    def draw(shape, stddev, dtype=dtype):
        return layers.truncated_normal(generator, shape, stddev, device, dtype)

    p = {
        "router": draw((d, n), d ** -0.5, torch.float32),
        "experts": {
            "w_gate": draw((n, d, f), d ** -0.5),
            "w_up": draw((n, d, f), d ** -0.5),
            "w_down": draw((n, f, d), f ** -0.5),
        },
    }
    if m.num_shared:
        # shared experts are always-on: fuse them into one wide ffn
        p["shared"] = layers.mlp_init(generator, d, f * m.num_shared, device,
                                      dtype)
    return p


def _expert_ffn(bank, x):
    """x: (e, g, c, d) -> (e, g, c, d) through per-expert SwiGLU."""
    h = torch.einsum("egcd,edf->egcf", x, bank["w_gate"])
    h = shard(h, "experts", "moe_groups", None, "expert_ff")
    u = torch.einsum("egcd,edf->egcf", x, bank["w_up"])
    u = shard(u, "experts", "moe_groups", None, "expert_ff")
    h = shard(F.silu(h) * u, "experts", "moe_groups", None, "expert_ff")
    out = torch.einsum("egcf,efd->egcd", h, bank["w_down"])
    return shard(out, "experts", "moe_groups", None, "d_model")


def route(params, cfg: ArchConfig, xg):
    """The float32 router on (g, t, d) token groups: its logits, its
    probabilities, and each token's top-k (probabilities, expert indices)."""
    logits = torch.einsum("gtd,de->gte", xg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)                          # (g,t,e)
    top_vals, top_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)   # (g,t,k)
    return logits, probs, top_vals, top_idx


def moe_ffn(params, cfg: ArchConfig, x):
    """x: (b, s, d). Returns (y, aux_losses dict)."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    tokens = b * s
    g_tokens = min(m.group_size, s)
    n_groups = tokens // g_tokens
    capacity = math.ceil(g_tokens * k * m.capacity_factor / e) if e else 0
    capacity = max(capacity, k)

    # gather the sequence-parallel shards BEFORE grouping so the group dim
    # carries only the batch axes (consistent with the expert einsums).
    x = shard(x, "batch", "seq", "d_model")
    xg = x.reshape(n_groups, g_tokens, d)
    xg = shard(xg, "moe_groups", None, "d_model")
    logits, probs, top_vals, top_idx = route(params, cfg, xg)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)

    # expert assignment mask, rank-major priority for capacity slots
    onehot = F.one_hot(top_idx, e).float()                         # (g,t,k,e)
    rank_major = onehot.transpose(1, 2).reshape(n_groups, k * g_tokens, e)
    pos = torch.cumsum(rank_major, dim=1) - 1.0          # slot per assignment
    pos = pos.reshape(n_groups, k, g_tokens, e).transpose(1, 2)    # (g,t,k,e)
    keep = (pos < capacity) & (onehot > 0)
    slot = torch.sum(pos * onehot, dim=-1)                         # (g,t,k)

    # a dropped assignment's slot is >= capacity: its row is all zeros, as
    # jax.nn.one_hot gives (F.one_hot would raise)
    slots = torch.arange(capacity, device=x.device)
    slot_oh = (slot.long()[..., None] == slots).to(x.dtype)        # (g,t,k,c)
    kept = torch.sum(keep, dim=-1).to(x.dtype)                     # (g,t,k)
    dispatch = torch.einsum("gtke,gtkc->gtec",
                            onehot.to(x.dtype) * kept[..., None], slot_oh)
    dispatch = shard(dispatch, "moe_groups", None, None, None)
    # combine weights: scale each kept assignment by its gate value
    gate_per_expert = torch.einsum("gtke,gtk->gte", onehot.to(x.dtype),
                                   top_vals.to(x.dtype))
    combine = dispatch * gate_per_expert[..., None]

    expert_in = torch.einsum("gtec,gtd->egcd", dispatch, xg)
    expert_in = shard(expert_in, "experts", "moe_groups", None, "d_model")
    expert_out = _expert_ffn(params["experts"], expert_in)
    y = torch.einsum("gtec,egcd->gtd", combine, expert_out)

    if m.num_shared:
        y = y + layers.mlp(params["shared"], xg)

    # aux losses (computed per group, then averaged)
    me = torch.mean(probs, dim=1)                      # (g,e) router prob mass
    ce = torch.mean(onehot.sum(2), dim=1)              # (g,e) fraction routed
    aux = e * torch.mean(torch.sum(me * ce, dim=-1))
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    losses = {"moe_aux": m.router_aux_weight * aux,
              "moe_z": m.router_z_weight * z}
    # back on the batch axes before the residual add: on DTensors the
    # reshape of groups into rows leaves a placement the next block's
    # products cannot take
    return shard(y.reshape(b, s, d), "batch", "seq", "d_model"), losses
