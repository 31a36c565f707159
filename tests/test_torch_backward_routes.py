"""The two backward kernels' designs, their order of sums and roundings
emulated in torch on the CPU and held against ``jax.vjp`` of the JAX
package's functions (``repro.kernels.ref.flash_attention_ref`` with K/V
repeated to the query heads, and ``repro.models.ssm.ssd_chunked``), at the
tolerances of test_torch_kernel_grads.py: 1e-5 in f32 and 2e-2 in bf16 of
the largest |grad| (plus one).

Flash attention's backward (``csrc/flash_attention_bwd.cu``): blocks of BK
keys of one KV head (32 for f32 at head dim 128, else 64), taken key tile
first; query tiles of 64, walked in one order by every block (from the
last with causal, from the first without); S and dP formed once a (query tile, key tile, head); three TF32
passes with operands split once in f32, P and dS rounded to bf16 before
their products in bf16; dV and dK summed over the block's tiles; dQ's parts
added into an f32 sum in the order of the key tiles, the first writing,
with the kernel's counter protocol checked at every add.

The SSD scan (``csrc/ssd_scan.cu``, ``csrc/ssd_scan_bwd.cu``): the
forward's f64 cumulative sums, scores G = C.B^T once a chunk, chunk states
(w B)^T x, the state pass, and the output's decay-weighted G tiles times x,
below the diagonal as G_ij u_i w_j against one reference (the step before
the row tile) and on it from each pair's own difference; its kept scratch
(the sums, G, the entering states).  The backward's six launches: local
states, the state pass backwards, dx (the entering term, Z_j = sum_i G_ij
exp(cum_i - cum_j) dy_i against one reference a column tile, and V as a
dot with x_j), dG a tile pair (dW = dy_i x_j^T once a head, R's row sums
and E's column sums from the same values, dG summed over the heads, the
even heads' sum plus the odd heads'), dt, and the sums (dC and dB from dG and, for the state
terms, one product whose K runs over (head, channel), items alternating
between two sums that are added last); three TF32 passes.

Nothing on the main path calls these emulations: they are the place to try
an order before the card.  The kernels themselves run on a card in
test_torch_cuda.py and chip_smoke.py's phase 13."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ref

LOG2E = 1.4426950408889634
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BQ = 64         # query rows a tile (flash) and steps a tile (SSD)


def _tf32_rna(x):
    """float32 to TF32, to nearest with ties away from zero (cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _tf32x3(a, b):
    """a @ b in three TF32 passes, lo.hi + hi.lo + hi.hi, f32 sums."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _product(a, b, f32):
    """A tensor-core product: three TF32 passes (f32), or operands that are
    bf16 values with f32 sums."""
    return _tf32x3(a, b) if f32 else a @ b


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _assert_scaled_close(actual, expected, tol):
    actual = actual.detach().float().numpy()
    expected = np.asarray(expected, np.float32)
    assert actual.shape == expected.shape
    scale = np.abs(expected).max() + 1.0
    np.testing.assert_allclose(actual / scale, expected / scale, atol=tol)


# ------------------------------------------------------- flash attention
def block_keys(dtype, d):
    """Keys a block of the main launch."""
    return 32 if dtype == torch.float32 and d == 128 else 64


def seen_by(j, bk, sq, sk, causal, window):
    """(start, n): the query tiles that see some key of key tile j."""
    nqt = -(-sq // BQ)
    if not causal:
        return 0, nqt
    k0 = j * bk
    k1 = min(k0 + bk, sk)
    hi = min(sq, k1 - 1 + window) if window else sq
    start = k0 // BQ
    return start, (-(-hi // BQ) - start if k0 < hi else 0)


def _walk(j, bk, sq, sk, causal, window, heads):
    """The block's steps in order: (query tile, head, adds to dQ)."""
    nqt = -(-sq // BQ)
    start, n = seen_by(j, bk, sq, sk, causal, window)
    if causal:
        tiles = [start + n - 1 - u for u in range(n)]
    else:
        tiles = list(range(n))
    steps = [(qt, head, True) for qt in tiles for head in heads]
    if causal and window and sk - 1 + window < sq:
        start2 = max((sk - 1 + window) // BQ, start + n)
        steps += [(qt, head, False) for qt in range(start2, nqt)
                  for head in heads]
    return steps


def emulate_flash_bwd(q, k, v, out, lse, grad_out, causal=True, window=None):
    """The backward kernel's arithmetic, block by block in ticket order.
    q, out, grad_out (b, h, sq, d); k, v (b, kv, sk, d); lse (b, h, sq) f32
    from the forward.  Returns (dq, dk, dv) in q's dtype."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    group = h // kv
    f32 = q.dtype == torch.float32
    bk = block_keys(q.dtype, d)
    scale = d ** -0.5
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, grad_out))
    nqt, nkt = -(-sq // BQ), -(-sk // bk)
    rows = torch.arange(nqt * BQ)

    # launch 1: lse in log2 units (+inf where a row sees no key), D
    no_key = ((rows - (sk - 1) >= window) if causal and window
              else torch.zeros_like(rows, dtype=torch.bool))
    no_key = no_key & (rows < sq)
    lse2 = torch.full((b, h, nqt * BQ), math.inf)
    lse2[..., :sq] = lse.float() * LOG2E
    lse2 = torch.where(no_key, torch.tensor(math.inf), lse2)
    dsum = torch.zeros(b, h, nqt * BQ)
    dsum[..., :sq] = (gf * of).sum(-1)

    def padded(t, start, n_rows):
        tile = torch.zeros(n_rows, d)
        part = t[start:start + n_rows]
        tile[:part.shape[0]] = part
        return tile

    dq_acc = torch.zeros(b, h, nqt * BQ, d)
    counters = torch.zeros(b, h, nqt, dtype=torch.int64)
    dk = torch.zeros(b, kv, sk, d)
    dv = torch.zeros(b, kv, sk, d)
    # launch 2, tickets with the key tile outermost
    for j in range(nkt):
        k0 = j * bk
        keys = torch.arange(k0, k0 + bk)
        prev = seen_by(j - 1, bk, sq, sk, causal, window) if j else (0, 0)
        for row in range(b):
            for kv_head in range(kv):
                K = padded(kf[row, kv_head], k0, bk)
                V = padded(vf[row, kv_head], k0, bk)
                dv_t = torch.zeros(d, bk)      # dV^T and dK^T
                dk_t = torch.zeros(d, bk)
                heads = range(kv_head * group, (kv_head + 1) * group)
                for qt, head, adds in _walk(j, bk, sq, sk, causal, window,
                                            heads):
                    q0 = qt * BQ
                    r = rows[q0:q0 + BQ, None]
                    Q = padded(qf[row, head], q0, BQ)
                    dO = padded(gf[row, head], q0, BQ)
                    s = _product(Q, K.T, f32)
                    dp = _product(dO, V.T, f32)
                    kept = keys[None] < sk
                    if causal:
                        kept = kept & (keys[None] <= r)
                        if window:
                            kept = kept & (r - keys[None] < window)
                    p = torch.exp2(s * scale_log2 - lse2[row, head, q0:q0 + BQ,
                                                         None])
                    p = torch.where(kept, p, torch.zeros(()))
                    ds = p * (dp - dsum[row, head, q0:q0 + BQ, None])
                    pv = p + torch.where(
                        (keys[None] < sk) & no_key[q0:q0 + BQ, None],
                        torch.tensor(1.0 / sk), torch.zeros(()))
                    if not f32:                 # rounded before products
                        pv, ds = _bf16(pv), _bf16(ds)
                    # dV^T += dO^T P, dK^T += Q^T dS: each tile's part
                    # summed apart and added in f32
                    dv_t = dv_t + _product(dO.T, pv, f32)
                    dk_t = dk_t + _product(Q.T, ds, f32)
                    if not adds:
                        continue
                    # dQ's part, after key tile j - 1's, as the counter says
                    first = not prev[0] <= qt < prev[0] + prev[1]
                    assert counters[row, head, qt] == (0 if first else j)
                    part = _product(ds, K, f32)
                    at = slice(q0, q0 + BQ)
                    dq_acc[row, head, at] = (part if first else
                                             dq_acc[row, head, at] + part)
                    counters[row, head, qt] = j + 1
                n = min(bk, sk - k0)
                dk[row, kv_head, k0:k0 + n] = (dk_t.T * scale)[:n]
                dv[row, kv_head, k0:k0 + n] = dv_t.T[:n]
    # launch 3: dq = scale * the sum, zeros where no key tile added
    added = (counters > 0).repeat_interleave(BQ, dim=2)[..., None]
    dq = torch.where(added, dq_acc * scale, torch.zeros(()))[:, :, :sq]
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _flash_arrays(b, h, kv, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d), (b, h, sq, d))]


def _jax_flash_grads(q, k, v, g, causal, window):
    """jax.vjp of the JAX package's plain attention, K/V repeated to the
    query heads and dK/dV summed over each group."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    group = h // kv

    def attend(q, k, v):
        return jax_ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
    _, vjp = jax.vjp(attend, jnp.asarray(q),
                     jnp.asarray(np.repeat(k, group, axis=1)),
                     jnp.asarray(np.repeat(v, group, axis=1)))
    dq, dk, dv = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    return (dq, dk.reshape(b, kv, group, sk, d).sum(axis=2),
            dv.reshape(b, kv, group, sk, d).sum(axis=2))


# (label, b, h, kv, sq, sk, d, causal, window, dtype)
FLASH_CASES = [
    ("gqa_window_d16", 1, 4, 2, 100, 100, 16, True, 24, "float32"),
    ("d128_causal", 1, 2, 1, 130, 130, 128, True, None, "float32"),
    ("d128_window", 1, 2, 2, 160, 160, 128, True, 40, "float32"),
    ("no_key_rows", 1, 2, 2, 300, 100, 64, True, 64, "float32"),
    ("cross_ragged", 2, 4, 2, 70, 150, 32, False, None, "float32"),
    ("bf16_d16_gqa", 1, 4, 1, 100, 100, 16, True, None, "bfloat16"),
    ("bf16_d128_window", 1, 2, 1, 150, 150, 128, True, 50, "bfloat16"),
    ("bf16_cross", 1, 2, 2, 65, 129, 64, False, None, "bfloat16"),
]


@pytest.mark.parametrize("label,b,h,kv,sq,sk,d,causal,window,dtype",
                         FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_bwd_emulation_matches_jax_vjp(label, b, h, kv, sq, sk, d,
                                             causal, window, dtype):
    arrays = _flash_arrays(b, h, kv, sq, sk, d, seed=sq + 3 * d)
    q, k, v, g = (torch.as_tensor(a).to(getattr(torch, dtype))
                  for a in arrays)
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    grads = emulate_flash_bwd(q, k, v, out, lse, g, causal, window)
    # the JAX reference on the same (rounded) values, in f32
    expected = _jax_flash_grads(*(t.float().numpy() for t in (q, k, v, g)),
                                causal, window)
    for actual, e in zip(grads, expected):
        assert actual.dtype == q.dtype
        _assert_scaled_close(actual, e, TOL[dtype])


@pytest.mark.parametrize("sq,sk,bk,causal,window", [
    (300, 300, 64, True, None), (300, 300, 32, True, None),
    (500, 500, 64, True, 70), (200, 400, 32, True, 33),
    (300, 100, 64, True, 64), (130, 260, 64, False, None)])
def test_flash_bwd_key_tiles_that_see_a_query_tile_are_contiguous(
        sq, sk, bk, causal, window):
    """The ordering's premise: the key tiles that see a query tile form one
    run, so 'the tile before it' is j - 1, and every run has a first."""
    nqt, nkt = -(-sq // BQ), -(-sk // bk)
    for qt in range(nqt):
        seers = [j for j in range(nkt)
                 if seen_by(j, bk, sq, sk, causal, window)[0] <= qt
                 < sum(seen_by(j, bk, sq, sk, causal, window))]
        assert seers == list(range(seers[0], seers[-1] + 1)) if seers else True
        # and exactly the key tiles with a kept (row, key) pair
        rows = np.arange(qt * BQ, min(sq, qt * BQ + BQ))[:, None]
        expected = []
        for j in range(nkt):
            keys = np.arange(j * bk, min(sk, j * bk + bk))[None]
            kept = np.ones((rows.size, keys.size), bool)
            if causal:
                kept &= keys <= rows
                if window:
                    kept &= rows - keys < window
            if kept.any():
                expected.append(j)
        assert seers == expected


@pytest.mark.parametrize("sq,sk,bk,causal,window", [
    (300, 300, 64, True, None), (300, 300, 32, True, None),
    (500, 500, 64, True, 70), (200, 400, 32, True, 33),
    (300, 100, 64, True, 64), (1500, 1500, 64, False, None),
    (448, 1500, 64, False, None), (130, 260, 32, False, None)])
def test_flash_bwd_walks_keep_each_key_tile_a_step_behind_the_last(
        sq, sk, bk, causal, window):
    """No block waits on a later step of the block before it: each (query
    tile, head) that key tiles j - 1 and j both add to comes in j - 1's
    walk no later than in j's, so the key tiles of a (batch row, KV head)
    run side by side and never one after another."""
    heads = range(2)
    nkt = -(-sk // bk)
    for j in range(1, nkt):
        before = {(qt, head): at for at, (qt, head, adds) in enumerate(
            _walk(j - 1, bk, sq, sk, causal, window, heads)) if adds}
        for at, (qt, head, adds) in enumerate(
                _walk(j, bk, sq, sk, causal, window, heads)):
            if adds and (qt, head) in before:
                assert before[qt, head] <= at


# --------------------------------------------------------------- SSD scan
def _chunk_cum(dt, A, b, nc, chunk, h):
    """The forward's f64 inclusive sums of dt * A (f32 products) a chunk."""
    return torch.cumsum((dt.float() * A.float()).reshape(b, nc, chunk, h)
                        .to(torch.float64), dim=2)


def _exp(x):
    """exp of an f64 difference, rounded to f32 first as the kernels do."""
    return torch.exp(x.float())


def emulate_ssd_fwd(x, dt, A, B, C, chunk, h0=None):
    """The forward kernel's arithmetic.  Returns (y, final_state, (cum,
    G, S_in)) with the kept scratch laid out as the kernel keeps it: cum (b,
    s, h) f64, G (b, nc, Q, Q) and the states entering each chunk (b, nc,
    h, n, p)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    f3 = _tf32x3
    xs, dtf = x.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    cum = _chunk_cum(dt, A, b, nc, chunk, h)                 # (b, nc, Q, h)
    G = torch.zeros(b, nc, chunk, chunk)
    S_c = torch.zeros(b, nc, h, n, p)
    y = torch.zeros(b, s, h, p)
    tiles = range(0, chunk, BQ)
    # 1. the chunk launch: G a chunk, each head's chunk state
    for row in range(b):
        for c in range(nc):
            t = slice(c * chunk, (c + 1) * chunk)
            cm = cum[row, c]
            G[row, c] = f3(Cf[row, t], Bf[row, t].T)
            w = _exp(cm[-1][None] - cm) * dtf[row, t]           # (Q, h)
            for hd in range(h):
                S_c[row, c, hd] = f3((w[:, hd, None] * Bf[row, t]).T,
                                     xs[row, t, hd])
    # 2. the state pass
    S_in = torch.zeros(b, nc, h, n, p)
    final = torch.zeros(b, h, n, p)
    for row in range(b):
        state = torch.zeros(h, n, p) if h0 is None else h0[row].float()
        for c in range(nc):
            S_in[row, c] = state
            state = _exp(cum[row, c, -1])[:, None, None] * state \
                + S_c[row, c]
        final[row] = state
    # 3. the output: per row tile, C . S_in, then the tiles at or below it
    for row in range(b):
        for c in range(nc):
            t0 = c * chunk
            cm = cum[row, c]
            d_t = dtf[row, t0:t0 + chunk]
            for ti, i0 in enumerate(tiles):
                ci = slice(i0, min(i0 + BQ, chunk))
                rows = torch.arange(i0, ci.stop)
                for hd in range(h):
                    acc = f3(_exp(cm[ci, hd])[:, None] * Cf[row, t0 + i0:
                                                        t0 + ci.stop],
                             S_in[row, c, hd])
                    if i0 > 0:
                        ref_ = cm[i0 - 1, hd]
                        u = _exp(cm[ci, hd] - ref_)
                        w = _exp(ref_ - cm[:i0, hd]) * d_t[:i0, hd]
                        acc = acc + f3(G[row, c, ci, :i0] * u[:, None]
                                       * w[None], xs[row, t0:t0 + i0, hd])
                    cols = torch.arange(i0, ci.stop)
                    keep = cols[None] <= rows[:, None]
                    diff = cm[ci, hd][:, None] - cm[ci, hd][None]
                    m = torch.where(keep, G[row, c, ci, ci] * _exp(
                        torch.where(keep, diff, torch.zeros(()))) *
                        d_t[ci, hd][None], torch.zeros(()))
                    acc = acc + f3(m, xs[row, t0 + i0:t0 + ci.stop, hd])
                    y[row, t0 + i0:t0 + ci.stop, hd] = acc
    return y, final, (cum.reshape(b, s, h), G, S_in)


def emulate_ssd_bwd(x, dt, A, B, C, h0, grad_y, grad_final, chunk):
    """The backward kernel's arithmetic, from the forward's kept scratch.
    Returns (dx, ddt, dA, dB, dC, dh0) as ``ref.ssd_scan_bwd_ref``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    f64 = torch.float64
    f3 = _tf32x3
    xs, dys = x.float(), grad_y.float()
    Bf, Cf, dtf, Af = B.float(), C.float(), dt.float(), A.float()
    _, _, (cum_flat, G, S_in) = emulate_ssd_fwd(x, dt, A, B, C, chunk, h0)
    cum = cum_flat.reshape(b, nc, chunk, h)
    tiles = list(range(0, chunk, BQ))

    # 1-2. local states and the state pass backwards: dS' a chunk, dh0
    dS = torch.zeros(b, nc, h, n, p)
    dh0 = torch.zeros(b, h, n, p)
    for row in range(b):
        grad = grad_final[row].float()
        for c in reversed(range(nc)):
            t = slice(c * chunk, (c + 1) * chunk)
            dS[row, c] = grad
            u = _exp(cum[row, c])                                 # (Q, h)
            local = torch.stack([f3((u[:, hd, None] * Cf[row, t]).T,
                                    dys[row, t, hd]) for hd in range(h)])
            grad = _exp(cum[row, c, -1])[:, None, None] * grad + local
        dh0[row] = grad

    dx = torch.zeros(b, s, h, p)
    dB = torch.zeros(b, s, n)
    dC = torch.zeros(b, s, n)
    ddt = torch.zeros(b, s, h)
    dA_parts = []
    for row in range(b):
        for c in range(nc):
            t0 = c * chunk
            cm = cum[row, c]                                       # (Q, h)
            d_t = dtf[row, t0:t0 + chunk]
            Bc, Cc = Bf[row, t0:t0 + chunk], Cf[row, t0:t0 + chunk]
            xc, dyc = xs[row, t0:t0 + chunk], dys[row, t0:t0 + chunk]
            Gc, S, dSp = G[row, c], S_in[row, c], dS[row, c]
            last = cm[-1]
            entering = torch.zeros(chunk, h)
            e_sum = torch.zeros(chunk, h)
            v_terms = torch.zeros(chunk, h)
            r_parts = torch.zeros(len(tiles), chunk, h)
            # 3. dx, a column tile j and head at a time
            for j0 in tiles:
                cj = slice(j0, min(j0 + BQ, chunk))
                past = j0 + BQ
                for hd in range(h):
                    side = f3(_exp(cm[cj, hd])[:, None] * Cc[cj], S[hd])
                    entering[cj, hd] = (dyc[cj, hd] * side).sum(1)
                    jj = torch.arange(j0, cj.stop)
                    ii = torch.arange(j0, cj.stop)
                    keep = ii[None] >= jj[:, None]                 # (j, i)
                    diff = cm[cj, hd][None] - cm[cj, hd][:, None]
                    a = torch.where(keep, Gc[cj, cj].T * _exp(torch.where(
                        keep, diff, torch.zeros(()))), torch.zeros(()))
                    z = f3(a, dyc[cj, hd])
                    if past < chunk:
                        ref_ = cm[past - 1, hd]
                        wrow = _exp(ref_ - cm[cj, hd])
                        u = _exp(cm[past:, hd] - ref_)
                        z = z + f3(Gc[past:, cj].T * wrow[:, None] * u[None],
                                   dyc[past:, hd])
                    side = f3(_exp(last[hd] - cm[cj, hd])[:, None] * Bc[cj],
                              dSp[hd])
                    v_terms[cj, hd] = (xc[cj, hd] * side).sum(1)
                    dx[row, t0 + j0:t0 + cj.stop, hd] = (
                        d_t[cj, hd][:, None] * (z + side))
            # 4. dG a tile pair, summed over the even heads, then the odd
            dg_pairs = {}
            for it, i0 in enumerate(tiles):
                ci = slice(i0, min(i0 + BQ, chunk))
                for jt in range(it + 1):
                    j0 = tiles[jt]
                    cj = slice(j0, min(j0 + BQ, chunk))
                    sums = []
                    for parity in (0, 1):
                        dg = torch.zeros(ci.stop - i0, cj.stop - j0)
                        for hd in range(parity, h, 2):
                            dw = f3(dyc[ci, hd], xc[cj, hd].T)
                            if it == jt:
                                ii = torch.arange(i0, ci.stop)[:, None]
                                jj = torch.arange(j0, cj.stop)[None]
                                diff = (cm[ci, hd][:, None]
                                        - cm[cj, hd][None])
                                fe = torch.where(jj <= ii, _exp(torch.where(
                                    jj <= ii, diff, torch.zeros(()))),
                                    torch.zeros(()))
                            else:
                                ref_ = cm[j0 + BQ - 1, hd]
                                fe = (_exp(cm[ci, hd] - ref_)[:, None]
                                      * _exp(ref_ - cm[cj, hd])[None])
                            # E, whose row sums (R) and column sums come
                            # from the same values
                            wf = dw * fe
                            e = wf * Gc[ci, cj]
                            r_parts[jt, ci, hd] = (e * d_t[cj, hd][None]
                                                   ).sum(1)
                            e_sum[cj, hd] += e.sum(0)
                            dg = dg + wf * d_t[cj, hd][None]
                        sums.append(dg)
                    dg_pairs[it, jt] = sums[0] + sums[1]
            # 6. the sums: items alternate between two sums, added last
            ecum = _exp(cm)                                        # (Q, h)
            wq = _exp(last[None] - cm) * d_t
            for tt, r0 in enumerate(tiles):
                cr = slice(r0, min(r0 + BQ, chunk))
                for role in (0, 1):
                    items = []
                    if role == 0:
                        for jt in range(tt + 1):
                            j0 = tiles[jt]
                            for k0 in range(j0, min(j0 + BQ, chunk), 32):
                                k1 = min(k0 + 32, chunk)
                                items.append((dg_pairs[tt, jt][:, k0 - j0:
                                                               k1 - j0],
                                              Bc[k0:k1]))
                    else:
                        for it in range(tt, len(tiles)):
                            i0 = tiles[it]
                            for k0 in range(i0, min(i0 + BQ, chunk), 32):
                                k1 = min(k0 + 32, chunk)
                                items.append((dg_pairs[it, tt][k0 - i0:
                                                               k1 - i0].T,
                                              Cc[k0:k1]))
                    for hd in range(h):
                        for p0 in range(0, p, 32):
                            cp = slice(p0, min(p0 + 32, p))
                            if role == 0:
                                items.append((ecum[cr, hd][:, None]
                                              * dyc[cr, hd, cp], S[hd][:, cp].T))
                            else:
                                items.append((wq[cr, hd][:, None]
                                              * xc[cr, hd, cp],
                                              dSp[hd][:, cp].T))
                    acc = [torch.zeros(cr.stop - r0, n) for _ in range(2)]
                    for k, (a, bm) in enumerate(items):
                        acc[k & 1] = acc[k & 1] + f3(a, bm)
                    out = dC if role == 0 else dB
                    out[row, t0 + r0:t0 + cr.stop] = acc[0] + acc[1]
            # 5. d.cum from the parts, R's partials summed in tile order
            r_sum = r_parts[0]
            for jt in range(1, len(tiles)):
                r_sum = r_sum + r_parts[jt]
            inner = (S * dSp).sum(dim=(-1, -2))
            tail = (d_t * v_terms).double().sum(0) + torch.exp(last) * inner
            da = torch.zeros(h, dtype=f64)
            part = torch.zeros(h, dtype=f64)
            for i in reversed(range(chunk)):
                dd = d_t[i].double()
                da = da + (r_sum[i].double() - dd * e_sum[i].double()
                           + entering[i].double() - dd * v_terms[i].double())
                if i == chunk - 1:
                    da = da + tail
                ddt[row, t0 + i] = (e_sum[i].double() + v_terms[i].double()
                                    + Af.double() * da).float()
                part = part + dd * da
            dA_parts.append(part.float())
    dA = dA_parts[0]
    for part in dA_parts[1:]:
        dA = dA + part
    return (dx.to(x.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype),
            None if h0 is None else dh0)


def _ssd_arrays(b, s, h, p, n, seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, s, h, p), np.abs(rng.randn(b, s, h)) * 0.1 + 0.01,
              -(np.abs(rng.randn(h)) + 0.5), rng.randn(b, s, n),
              rng.randn(b, s, n), rng.randn(b, h, n, p),
              rng.randn(b, s, h, p), rng.randn(b, h, n, p)]
    return [a.astype(np.float32) for a in arrays]


# (label, b, s, h, p, n, chunk, with h0, dtype)
SSD_CASES = [
    ("chunk64_h0", 1, 128, 3, 16, 16, 64, True, "float32"),
    ("two_groups", 1, 128, 10, 16, 8, 128, False, "float32"),
    ("ragged_tile", 1, 200, 2, 16, 12, 100, True, "float32"),
    ("bf16_h0", 1, 128, 3, 16, 16, 64, True, "bfloat16"),
]


@pytest.mark.parametrize("label,b,s,h,p,n,chunk,with_h0,dtype", SSD_CASES,
                         ids=[c[0] for c in SSD_CASES])
def test_ssd_bwd_emulation_matches_jax_vjp(label, b, s, h, p, n, chunk,
                                           with_h0, dtype):
    x, dt, A, B, C, h0, gy, gf = _ssd_arrays(b, s, h, p, n, seed=s + h)
    cast = getattr(torch, dtype)
    xt, Bt, Ct = (torch.as_tensor(a).to(cast) for a in (x, B, C))
    grads = emulate_ssd_bwd(xt, torch.as_tensor(dt), torch.as_tensor(A), Bt,
                            Ct, torch.as_tensor(h0) if with_h0 else None,
                            torch.as_tensor(gy), torch.as_tensor(gf), chunk)
    # the JAX reference on the same (rounded) values, in f32
    x, B, C = (t.float().numpy() for t in (xt, Bt, Ct))
    primals = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    if with_h0:
        def scan(x, dt, A, B, C, h0):
            return ssd_chunked(x, dt, A, B, C, chunk, h0=h0)
        primals.append(jnp.asarray(h0))
    else:
        def scan(x, dt, A, B, C):
            return ssd_chunked(x, dt, A, B, C, chunk)
    _, vjp = jax.vjp(scan, *primals)
    expected = [np.asarray(t) for t in vjp((jnp.asarray(gy),
                                            jnp.asarray(gf)))]
    assert (grads[5] is None) == (not with_h0)
    for actual, e in zip(grads, expected):
        _assert_scaled_close(actual, e, TOL[dtype])


@pytest.mark.parametrize("label,b,s,h,p,n,chunk,with_h0,dtype", SSD_CASES,
                         ids=[c[0] for c in SSD_CASES])
def test_ssd_fwd_emulation_matches_jax(label, b, s, h, p, n, chunk, with_h0,
                                       dtype):
    """The forward's decomposition against the JAX package's Pallas kernel
    in interpret mode (y, no initial state there) and its ``ssd_chunked``
    (y and the final state, with h0), and its kept scratch against what the
    scratch holds by definition."""
    x, dt, A, B, C, h0, _, _ = _ssd_arrays(b, s, h, p, n, seed=s + h + 1)
    cast = getattr(torch, dtype)
    xt, Bt, Ct = (torch.as_tensor(a).to(cast) for a in (x, B, C))
    h0t = torch.as_tensor(h0) if with_h0 else None
    y, final, (cum, G, S_in) = emulate_ssd_fwd(
        xt, torch.as_tensor(dt), torch.as_tensor(A), Bt, Ct, chunk, h0t)
    x, B, C = (t.float().numpy() for t in (xt, Bt, Ct))
    args = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    y_ref, final_ref = ssd_chunked(*args, chunk,
                                   h0=jnp.asarray(h0) if with_h0 else None)
    _assert_scaled_close(y, y_ref, TOL["float32"])
    _assert_scaled_close(final, final_ref, TOL["float32"])
    if not with_h0:
        _assert_scaled_close(y, jax_ops.ssd_scan(*args, chunk=chunk,
                                                 interpret=True),
                             TOL["float32"])
    nc = s // chunk
    Cc = torch.as_tensor(C).reshape(b, nc, chunk, n)
    Bc = torch.as_tensor(B).reshape(b, nc, chunk, n)
    _assert_scaled_close(G, (Cc @ Bc.transpose(-1, -2)).numpy(),
                         TOL["float32"])
    cum_ref = np.cumsum((dt * A).reshape(b, nc, chunk, h).astype(np.float64),
                        axis=2).reshape(b, s, h)
    assert np.abs(cum.numpy() - cum_ref).max() <= 1e-9 * (
        np.abs(cum_ref).max() + 1.0)
    assert S_in.shape == (b, nc, h, n, p)
    if with_h0:
        _assert_scaled_close(S_in[:, 0], h0, 0.0)
