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


def _attention_masks(sq, sk, causal, window, device, start=0, rows=None):
    """(kept, empty) for query rows [start, start + rows): ``kept`` (rows,
    sk) the (query, key) pairs the masks keep, ``empty`` (rows,) the rows
    that keep none (the mean of V in the forward)."""
    rows = sq - start if rows is None else rows
    qi = torch.arange(start, start + rows, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    kept = torch.ones((rows, sk), dtype=torch.bool, device=device)
    if causal:
        kept = qi >= ki
        if window is not None:
            kept &= (qi - ki) < window
    return kept, ~kept.any(dim=-1)


def flash_attention_lse_ref(q, k, *, causal=True, window=None, scale=None):
    """The log-sum-exp of each query row's masked scores, (b, h, sq) f32:
    what the flash kernel's forward writes for its backward.  A row that
    keeps no key scores -1e30 everywhere, so its lse is -1e30 (+ log sk,
    which f32 drops)."""
    sq, sk = q.shape[2], k.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = q.shape[1] // k.shape[1]
    kf = torch.repeat_interleave(k.float(), group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    kept, _ = _attention_masks(sq, sk, causal, window, q.device)
    scores = torch.where(kept, scores, torch.full_like(scores, NEG_INF))
    return torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_ref(q, k, v, out, lse, grad_out, *, causal=True,
                            window=None, scale=None):
    """The flash kernel's backward (FlashAttention-2, Dao 2023, Algorithm
    2), written out in f32: with S = scale q.k^T masked and
    P = exp(S - lse), D = rowsum(dO o O),
    dV = P^T dO, dP = dO V^T, dS = P o (dP - D), dQ = scale dS K,
    dK = scale dS^T Q; K/V heads sum their query heads' dK/dV.  A row that
    keeps no key weighs every key 1/sk in the forward, so it adds dO/sk to
    every dV row and nothing to dQ or dK.  Queries go in chunks of
    ``Q_CHUNK`` as in ``flash_attention_ref``.  Returns (dq, dk, dv) in
    q's, k's and v's dtypes."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    group = h // kv
    scale = scale if scale is not None else d ** -0.5
    kf = torch.repeat_interleave(k.float(), group, dim=1)
    vf = torch.repeat_interleave(v.float(), group, dim=1)
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    chunk = Q_CHUNK if sq % Q_CHUNK == 0 else sq
    for start in range(0, sq, chunk):
        rows = slice(start, start + chunk)
        qc, oc = q[:, :, rows].float(), out[:, :, rows].float()
        doc = grad_out[:, :, rows].float()
        kept, empty = _attention_masks(sq, sk, causal, window, q.device,
                                       start, qc.shape[2])
        seen = kept & ~empty[:, None]
        scores = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale
        p = torch.exp(scores - lse[:, :, rows, None].float())
        p = torch.where(seen, p, torch.zeros_like(p))
        p = torch.where(empty[:, None], torch.full_like(p, 1.0 / sk), p)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, doc)
        dp = torch.einsum("bhqd,bhkd->bhqk", doc, vf)
        D = (doc * oc).sum(dim=-1, keepdim=True)
        ds = torch.where(seen, p * (dp - D), torch.zeros_like(p))
        dqs.append(scale * torch.einsum("bhqk,bhkd->bhqd", ds, kf))
        dk += scale * torch.einsum("bhqk,bhqd->bhkd", ds, qc)
    dq = torch.cat(dqs, dim=2)
    dk = dk.reshape(b, kv, group, sk, d).sum(dim=2)
    dv = dv.reshape(b, kv, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_scan_bwd_ref(x, dt, A, B, C, h0, grad_y, grad_final, chunk):
    """The SSD kernel's backward, written out per chunk in f32 (Mamba2's
    chunked SSD backward, arXiv:2405.21060 section 7).  Per batch row and
    head, in a chunk with a_t = dt_t A and cum its inclusive sum, f_ij =
    exp(cum_i - cum_j) dt_j (j <= i), G = C.B^T, W = G o f, w_j =
    exp(cum_Q - cum_j) dt_j, S the state entering the chunk and dS' the
    gradient of the state leaving it:

      dS      = exp(cum_Q) dS' + sum_i exp(cum_i) C_i dy_i^T   (serial,
                from grad_final; dh0 is the first chunk's dS)
      dx_j    = sum_{i>=j} W_ij dy_i + w_j dS'^T B_j
      dG_ij   = (dy_i . x_j) f_ij
      dC_i    = sum_j dG_ij B_j + exp(cum_i) S dy_i      (summed over heads)
      dB_j    = sum_i dG_ij C_i + w_j dS' x_j            (summed over heads)

    and dt, A through d.cum: E_ij = (dy_i . x_j) G_ij exp(cum_i - cum_j),
    R_ij = E_ij dt_j adds sum_j R_ij to d.cum_i and takes sum_i R_ij off
    d.cum_j; dy_i . (exp(cum_i) S^T C_i) adds to d.cum_i; T_j = dt_j V_j,
    V_j = exp(cum_Q - cum_j) B_j . (dS' x_j), adds to d.cum_Q and comes off
    d.cum_j; exp(cum_Q) <S, dS'> adds to d.cum_Q.  d.a is d.cum's reverse
    cumulative sum in the chunk, ddt_t = sum_i E_it + V_t + A d.a_t and
    dA = sum over (b, s) of dt_t d.a_t.

    Returns (dx, ddt, dA, dB, dC, dh0): dx, dB and dC in x's, B's and C's
    dtypes, the others f32; dh0 is None when h0 is None."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xc = x.float().reshape(b, nc, chunk, h, p)
    dyc = grad_y.float().reshape(b, nc, chunk, h, p)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = B.float().reshape(b, nc, chunk, n)
    Cc = C.float().reshape(b, nc, chunk, n)
    Af = A.float()
    cum = torch.cumsum(dtc * Af, dim=2)                         # (b,c,Q,h)
    last = cum[:, :, -1]                                        # (b,c,h)
    decay = torch.exp(_segsum((dtc * Af).permute(0, 1, 3, 2)))  # (b,c,h,i,j)
    dt_j = dtc.permute(0, 1, 3, 2)[:, :, :, None, :]            # (b,c,h,1,j)
    G = (Cc @ Bc.transpose(-1, -2))[:, :, None]                 # (b,c,1,i,j)
    W = G * decay * dt_j
    w = torch.exp(last[:, :, None] - cum) * dtc                 # (b,c,Q,h)
    ecum = torch.exp(cum)

    # the states entering each chunk, as the forward passes them
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, w, xc)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(last[:, c])[..., None, None] + states[:, c]
    S = torch.stack(entering, dim=1)                            # (b,c,h,n,p)

    # reverse state passing: dS' of each chunk, and dh0
    local = torch.einsum("bcin,bcih,bcihp->bchnp", Cc, ecum, dyc)
    grad = grad_final.float()
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = grad
        grad = grad * torch.exp(last[:, c])[..., None, None] + local[:, c]
    dS = torch.stack(leaving, dim=1)                            # (b,c,h,n,p)

    dW = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    dG = dW * decay * dt_j
    dx = (torch.einsum("bchij,bcihp->bcjhp", W, dyc)
          + w[..., None] * torch.einsum("bcjn,bchnp->bcjhp", Bc, dS))
    SdY = torch.einsum("bchnp,bcihp->bcihn", S, dyc)            # S dy_i
    dSx = torch.einsum("bchnp,bcjhp->bcjhn", dS, xc)            # dS' x_j
    dC = (torch.einsum("bchij,bcjn->bcin", dG, Bc)
          + torch.einsum("bcih,bcihn->bcin", ecum, SdY))
    dB = (torch.einsum("bchij,bcin->bcjn", dG, Cc)
          + torch.einsum("bcjh,bcjhn->bcjn", w, dSx))

    E = dW * G * decay                                          # (b,c,h,i,j)
    R = E * dt_j
    V = (torch.exp(last[:, :, None] - cum)
         * torch.einsum("bcjn,bcjhn->bcjh", Bc, dSx))
    T = dtc * V
    entered = ecum * torch.einsum("bcin,bcihn->bcih", Cc, SdY)
    dcum = (R.sum(dim=-1) - R.sum(dim=-2)).permute(0, 1, 3, 2) + entered - T
    tail = T.sum(dim=2) + torch.exp(last) * (S * dS).sum(dim=(-1, -2))
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + tail[:, :, None]],
                     dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = E.sum(dim=-2).permute(0, 1, 3, 2) + V + Af * da
    dA = (dtc * da).sum(dim=(0, 1, 2))
    return (dx.reshape(b, s, h, p).to(x.dtype), ddt.reshape(b, s, h), dA,
            dB.reshape(b, s, n).to(B.dtype), dC.reshape(b, s, n).to(C.dtype),
            None if h0 is None else grad)
