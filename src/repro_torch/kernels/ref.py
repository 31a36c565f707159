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
