"""The flash kernel's two routes, their arithmetic emulated in torch on the
CPU and held against the JAX Pallas kernel (interpret mode) and the plain
version: the bf16 route (bf16 operands, f32 sums, the scale applied to S in
f32, P rounded to bf16 before P.V, an online softmax over key tiles of 128
from query tiles of 128) at 2e-2, and the f32 route at head dim 128 (three
TF32 passes, operands split once, Q pre-scaled before its split, each key
tile's P.V summed apart, key tiles of 32 from query tiles of 64) at 1e-4.
The routing rule and the bf16 route's alignment check are tested here too;
the kernels themselves run on a card in test_torch_cuda.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels import ref

LOG2E = 1.4426950408889634
NEG_INF = -1e30
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# (block_m, block_n): query rows a block and keys a tile, as the kernel's
BF16_TILES = (128, 128)
TF32_TILES = (64, 32)


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


def _walk(q0, block_m, sq, sk, causal, window, block_n):
    """(k_begin, n_tiles) of the query tile from q0, as the kernel's Walk."""
    q_last = min(q0 + block_m, sq) - 1
    k_begin, k_end = 0, sk
    if causal:
        k_end = min(sk, q_last + 1)
        if window is not None:
            if q_last - (sk - 1) >= window:
                k_end = sk
            else:
                k_begin = max(0, q0 - window + 1)
    return k_begin, -(-(k_end - k_begin) // block_n)


def emulate_route(q, k, v, causal=True, window=None, route="bf16"):
    """The route's arithmetic, tile by tile.  q: (b, h, sq, d); k, v:
    (b, kv, sk, d), kv dividing h; bf16 for the bf16 route, f32 for the
    TF32 route.  Returns (b, h, sq, d) in q's dtype."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    group = h // k.shape[1]
    kf = torch.repeat_interleave(k.float(), group, dim=1)
    vf = torch.repeat_interleave(v.float(), group, dim=1)
    block_m, block_n = BF16_TILES if route == "bf16" else TF32_TILES
    scale_log2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    out = torch.empty(b, h, sq, d, dtype=q.dtype)
    for q0 in range(0, sq, block_m):
        rows = torch.arange(q0, min(q0 + block_m, sq))
        qf = q[:, :, q0:q0 + block_m].float()
        k_begin, n_tiles = _walk(q0, block_m, sq, sk, causal, window,
                                 block_n)
        m = torch.full((b, h, len(rows), 1), NEG_INF)
        l = torch.zeros(b, h, len(rows), 1)
        o = torch.zeros(b, h, len(rows), d)
        for it in range(n_tiles):
            kt = k_begin + it * block_n
            keys = torch.arange(kt, kt + block_n)
            k_tile = torch.zeros(b, h, block_n, d)
            v_tile = torch.zeros(b, h, block_n, d)
            n = min(block_n, sk - kt)
            k_tile[:, :, :n], v_tile[:, :, :n] = (kf[:, :, kt:kt + n],
                                                  vf[:, :, kt:kt + n])
            if route == "bf16":
                s = (qf @ k_tile.transpose(2, 3)) * scale_log2
            else:           # Q pre-scaled in f32, then split
                s = _tf32x3(qf * scale_log2, k_tile.transpose(2, 3))
            i, j = rows[:, None], keys[None, :]
            hidden = (j > i) if causal else torch.zeros_like(j > i)
            if causal and window is not None:
                hidden = hidden | (i - j >= window)
            s = torch.where(hidden, torch.tensor(NEG_INF), s)
            s = torch.where(j >= sk, torch.tensor(-math.inf), s)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            if route == "bf16":     # P rounded to bf16 before P.V
                o = o * alpha + p.to(torch.bfloat16).float() @ v_tile
            else:                   # each tile's P.V summed apart
                o = o * alpha + _tf32x3(p, v_tile)
            m = m_new
        out[:, :, q0:q0 + block_m] = (o / l.clamp_min(1e-30)).to(q.dtype)
    return out


def _arrays(b, h, kv, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32),
            rng.randn(b, kv, sk, d).astype(np.float32),
            rng.randn(b, kv, sk, d).astype(np.float32))


def _torch(arrays, dtype):
    return tuple(torch.as_tensor(a).to(getattr(torch, dtype))
                 for a in arrays)


def _pallas(arrays, dtype, repeat, causal, window):
    """The JAX Pallas kernel in interpret mode, K/V repeated to the query
    heads (the JAX caller expands GQA)."""
    q, k, v = arrays
    k, v = np.repeat(k, repeat, axis=1), np.repeat(v, repeat, axis=1)
    cast = getattr(jnp, dtype)
    return np.asarray(jax_ops.flash_attention(
        jnp.asarray(q, cast), jnp.asarray(k, cast), jnp.asarray(v, cast),
        causal=causal, window=window, interpret=True), np.float32)


def _assert_close(actual, expected, dtype):
    np.testing.assert_allclose(actual.float().numpy(), expected,
                               atol=TOL[dtype], rtol=TOL[dtype])


MASKS = [(True, None), (True, 100), (False, None)]


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bf16_route_emulation_matches_pallas_kernel(d, causal, window):
    """GQA 6:1 over two query tiles and two key tiles of 128."""
    arrays = _arrays(1, 6, 1, 256, 256, d, seed=d + 7 * causal)
    out = emulate_route(*_torch(arrays, "bfloat16"), causal=causal,
                        window=window, route="bf16")
    assert out.dtype == torch.bfloat16
    _assert_close(out, _pallas(arrays, "bfloat16", 6, causal, window),
                  "bfloat16")


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("h,kv", [(2, 2), (6, 1)])
def test_tf32_route_emulation_at_head_dim_128_matches_pallas_kernel(
        h, kv, causal, window):
    """The f32 route at head dim 128: key tiles of 32 from query tiles of
    64, three TF32 passes with operands split once, at the f32 tolerance."""
    arrays = _arrays(1, h, kv, 256, 256, 128, seed=h + kv + 3 * causal)
    out = emulate_route(*_torch(arrays, "float32"), causal=causal,
                        window=window, route="tf32")
    _assert_close(out, _pallas(arrays, "float32", h // kv, causal, window),
                  "float32")


@pytest.mark.parametrize("sq,sk", [(1, 1), (63, 65), (129, 257), (300, 100)])
@pytest.mark.parametrize("route,dtype", [("bf16", "bfloat16"),
                                         ("tf32", "float32")])
def test_route_emulation_at_ragged_tiles_matches_plain_version(route, dtype,
                                                               sq, sk):
    """Ragged tiles (the Pallas kernel needs multiples of 128), windows
    ending inside a key tile, and with sq > sk rows past the last key,
    which get the mean of V, against the plain version."""
    arrays = _arrays(2, 4, 2, sq, sk, 64 if route == "bf16" else 128,
                     seed=sq * 7 + sk)
    q, k, v = _torch(arrays, dtype)
    for causal, window in MASKS + [(True, 40)]:
        out = emulate_route(q, k, v, causal=causal, window=window,
                            route=route)
        expected = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
        _assert_close(out, expected.float().numpy(), dtype)


@pytest.mark.parametrize("dtype,d,expected", [
    (torch.bfloat16, 16, "wgmma_tma_bf16"),
    (torch.bfloat16, 128, "wgmma_tma_bf16"),
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "tf32x3_split_once")])
def test_routes_are_chosen_by_dtype_and_head_dim(dtype, d, expected):
    assert flash_module.route(dtype, d) == expected


def test_tma_alignment_check_of_the_bf16_route():
    """TMA reads bases and strides that are multiples of 16 bytes; a
    dimension of extent 1 is never stepped, so its stride does not count."""
    aligned = flash_module._tma_aligned
    x = torch.zeros(2, 200, 8, 64, dtype=torch.bfloat16)
    assert aligned(x.transpose(1, 2))                 # the model's views
    shifted = torch.zeros(1 + x.numel(), dtype=torch.bfloat16)[1:]
    assert not aligned(shifted.view(2, 200, 8, 64).transpose(1, 2))
    odd = torch.zeros(1, 4, 30, 36, dtype=torch.bfloat16)[..., :16]
    assert not aligned(odd)                           # 72-byte row stride
    one = torch.zeros(1, 1, 1, 16, dtype=torch.bfloat16).as_strided(
        (1, 1, 1, 16), (3, 5, 7, 1))
    assert aligned(one)
