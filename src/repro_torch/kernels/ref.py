"""Plain PyTorch versions of the hand-written kernels (the allclose oracles).

The CPU tests run these, and ``chip_smoke.py`` holds each kernel against its
plain version on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, lengths):
    """q: (b, h, d); k, v: (b, s, kv, d) with kv dividing h (query head i
    reads KV head i // (h // kv)); lengths: (b,) valid prefix lengths.

    Scores and softmax in f32; output in q's dtype.  A row whose prefix
    masks every key gets the mean of V, as the JAX oracle does."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    qg = q.float().reshape(b, kv, h // kv, d)
    scores = torch.einsum("bngd,bsnd->bngs", qg, k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngs,bsnd->bngd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def vtrace_ref(values, next_values, rewards, discounts, rhos,
               clip_rho: float = 1.0, clip_c: float = 1.0):
    """V-trace targets (Espeholt et al. 2018), time-major (T, B) f32 inputs.

    vs_t = V_t + delta_t + gamma_t * c_t * (vs_{t+1} - V_{t+1}),
    delta_t = clipped_rho_t * (r_t + gamma_t * V_{t+1} - V_t);
    pg_adv_t = clipped_rho_t * (r_t + gamma_t * vs_{t+1} - V_t), with
    vs_T taken from next_values[T-1].  Returns (vs, pg_adv)."""
    rho_c = torch.clamp(rhos, max=clip_rho)
    cs = torch.clamp(rhos, max=clip_c)
    deltas = rho_c * (rewards + discounts * next_values - values)
    acc = torch.zeros_like(values[0])
    diffs = []
    for t in reversed(range(values.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        diffs.append(acc)
    vs = values + torch.stack(diffs[::-1])
    # policy-gradient advantages use vs_{t+1}
    vs_next = torch.cat([vs[1:], next_values[-1:]], dim=0)
    pg_adv = rho_c * (rewards + discounts * vs_next - values)
    return vs, pg_adv
