"""Plain PyTorch versions of the hand-written kernels (the allclose oracles).

The CPU tests run these, and ``chip_smoke.py`` holds each kernel against its
plain version on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
# the plain attention's query chunk, as the JAX package's
# ``models/attention.py::attention`` scans queries
Q_CHUNK = 1024


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                        q_chunk=None):
    """q: (b, h, sq, d); k, v: (b, kv, sk, d) with kv dividing h (query
    head i reads KV head i // (h // kv)).  Plain softmax attention.

    Masks by index: with ``causal``, query i sees key j when i >= j and,
    with a ``window``, i - j < window; without ``causal`` every key is seen
    and ``window`` is not applied, as in the JAX oracle and the model.
    Scores and softmax in f32; output in q's dtype.  Queries go in chunks
    of ``Q_CHUNK`` when that divides sq, else in one block, as the JAX
    package's ``models/attention.py::attention`` scans them: each row's
    softmax is its own, so this bounds the scores' memory and changes no
    row.  ``q_chunk`` replaces ``Q_CHUNK`` (sequence-parallel attention
    passes sq: one block)."""
    sq, sk = q.shape[2], k.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = q.shape[1] // k.shape[1]
    k = torch.repeat_interleave(k.float(), group, dim=1)
    v = torch.repeat_interleave(v.float(), group, dim=1)
    ki = torch.arange(sk, device=q.device)[None, :]

    def block(start, rows):
        scores = torch.einsum("bhqd,bhkd->bhqk",
                              q[:, :, start:start + rows].float(), k) * scale
        if causal:
            qi = torch.arange(start, start + rows, device=q.device)[:, None]
            mask = qi >= ki
            if window is not None:
                mask &= (qi - ki) < window
            scores = torch.where(mask, scores,
                                 torch.full_like(scores, NEG_INF))
        p = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)

    chunk = q_chunk or Q_CHUNK
    chunk = chunk if sq % chunk == 0 else sq
    if sq <= chunk:
        return block(0, sq)
    return torch.cat([block(i, chunk) for i in range(0, sq, chunk)], dim=2)


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


def _segsum(x):
    """x: (..., q) per-step log decays -> L[..., i, j] = sum_{j<k<=i} x[k],
    -inf above the diagonal (so exp gives 0 there, never inf)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, seg, torch.full_like(seg, -torch.inf))


def ssd_scan_ref(x, dt, A, B, C, chunk, h0=None):
    """Chunked SSD scan (Mamba2), the plain version of the SSD kernel: the
    JAX package's ``models/ssm.py::ssd_chunked``, which its
    ``kernels/ref.py::ssd_scan_ref`` delegates to.

    x: (b, s, h, p); dt: (b, s, h) step sizes (> 0); A: (h,) negative decay
    rates; B, C: (b, s, n) (one group); ``chunk`` divides s; h0: optional
    (b, h, n, p) state entering the first chunk.
    Returns (y (b, s, h, p) float32, final_state (b, h, n, p) float32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    x_c = x.float().reshape(b, nc, chunk, h, p)
    dt_c = dt.float().reshape(b, nc, chunk, h)
    B_c = B.float().reshape(b, nc, chunk, n)
    C_c = C.float().reshape(b, nc, chunk, n)

    dA = dt_c * A.float()                              # (b,nc,q,h) log decays
    dA_cum = torch.cumsum(dA, dim=2)                   # within-chunk cumulative

    # 1) intra-chunk (diagonal block): (C B^T o L o dt) x
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))     # (b,nc,h,q,k)
    scores = C_c @ B_c.transpose(-1, -2)               # (b,nc,q,k)
    M = scores[:, :, None] * L * dt_c.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = (M @ x_c.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # 2) chunk end-states: decay-weighted sum of inputs
    decay_to_end = torch.exp(dA_cum[:, :, -1:] - dA_cum)          # (b,nc,q,h)
    weighted = x_c * (dt_c * decay_to_end)[..., None]             # (b,nc,q,h,p)
    states = torch.einsum("bcqn,bcqhp->bchnp", B_c, weighted)

    # 3) inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(dA_cum[:, :, -1])                     # (b,nc,h)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)                    # (b,nc,h,n,p)

    # 4) inter-chunk contribution, decayed from the chunk's start
    y_off = torch.einsum("bcqn,bchnp->bcqhp", C_c, prev_states)
    y_off = y_off * torch.exp(dA_cum)[..., None]
    return (y_diag + y_off).reshape(b, s, h, p), state
