"""The decode kernel's two routes, their arithmetic emulated in torch on the
CPU and held against the JAX Pallas kernel (interpret mode) and the plain
version: the tensor-core route of bf16 queries over a bf16 cache (S^T =
K . q^T with bf16 operands and f32 sums, the scale applied to S in f32, an
online softmax a warp over 16-key chunks of 64-key tiles, P rounded to
bf16 before O^T = V^T . P^T, the warps merged in warp order) at 2e-2, and
the CUDA-core route of f32 queries (f32 products, over an f32 or a bf16
cache) at 1e-4; in both, the split plan's key ranges merged in rank order
as the cluster (or the combine launch) merges them.  The split plan's
routing is tested here too; the kernels themselves run on a card in
test_torch_cuda.py and chip_smoke.py."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch import configs
from repro_torch.kernels import decode_attention as decode_module
from repro_torch.kernels import ref

LOG2E = 1.4426950408889634
NEG_INF = -1e30
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
WARPS = 4
CHUNK = 16                 # keys a warp takes of a tensor-core tile
MMA_TILE = CHUNK * WARPS   # 64 keys
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _merge(parts):
    """(m, l, acc) partials merged in order: m* = max m_i, l = sum 2^(m_i -
    m*) l_i, acc likewise (an empty part, m = -1e30 and l = acc = 0, weighs
    exactly 0)."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    den = torch.zeros_like(mx)
    num = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        wt = torch.exp2(m - mx)
        den = den + wt * l
        num = num + wt[:, None] * acc
    return mx, den, num


def _chunk(state, k_rows, v_rows, qg, keys, end, masked, scale_log2,
           round_p):
    """One online-softmax step of a warp over the keys ``keys`` (those at
    or past ``end`` weigh 0): state (m, l, acc) per head of the group."""
    m, l, acc = state
    s = k_rows @ qg.T                                    # (keys, heads)
    inside = (keys < end)[:, None]
    s = torch.where(inside, torch.full_like(s, NEG_INF) if masked
                    else s * scale_log2, torch.full_like(s, -np.inf))
    m_new = torch.maximum(m, s.amax(0))
    alpha = torch.exp2(m - m_new)
    p = torch.exp2(s - m_new)
    l = l * alpha + p.sum(0)
    pv = p.to(torch.bfloat16).float() if round_p else p
    return m_new, l, acc * alpha[:, None] + pv.T @ v_rows


def _rows(x, keys, s):
    """Rows ``keys`` of x (s, d), zeros past s (as staged)."""
    out = torch.zeros(len(keys), x.shape[1])
    live = keys < s
    out[live] = x[keys[live]]
    return out


def emulate_route(q, k, v, lengths):
    """The kernel's arithmetic, split by split and warp by warp.  q:
    (b, h, d); k, v: (b, s, kv, d); lengths (b,).  bf16 q takes the
    tensor-core route (bf16 cache); f32 q the CUDA-core route.  Returns
    (b, h, d) in q's dtype."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    group = h // kv
    mma = q.dtype == torch.bfloat16
    splits, per_split = decode_module.plan_splits(b, kv, s, d, q.dtype,
                                                  k.dtype)
    tile = MMA_TILE if mma else decode_module.TILE_ELEMS // d
    scale_log2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    out = torch.empty(b, h, d, dtype=q.dtype)
    for row in range(b):
        length = int(lengths[row])
        masked = length < 1
        n_keys = s if masked else min(length, s)
        for kvh in range(kv):
            heads = slice(kvh * group, (kvh + 1) * group)
            qg = q[row, heads].float()
            k_all, v_all = k[row, :, kvh].float(), v[row, :, kvh].float()
            empty = (torch.full((group,), NEG_INF), torch.zeros(group),
                     torch.zeros(group, d))
            ranks = []
            for split in range(splits):
                begin = split * per_split
                end = min(begin + per_split, n_keys)
                warps = [empty] * WARPS
                for t0 in range(begin, end, tile):
                    length_t = min(tile, end - t0)
                    # each warp's keys of the tile: 16 of 64 (tensor
                    # cores), a quarter (CUDA cores)
                    share = CHUNK if mma else -(-length_t // WARPS)
                    for w in range(WARPS):
                        key0 = t0 + w * share
                        if key0 >= end or (not mma and key0 >= t0
                                           + length_t):
                            continue
                        keys = torch.arange(key0, key0 + (
                            CHUNK if mma else min(share,
                                                  t0 + length_t - key0)))
                        warps[w] = _chunk(warps[w], _rows(k_all, keys, s),
                                          _rows(v_all, keys, s), qg, keys,
                                          end, masked, scale_log2, mma)
                ranks.append(_merge(warps))
            _, den, num = _merge(ranks)
            out[row, heads] = (num / den.clamp_min(1e-30)[:, None]).to(
                q.dtype)
    return out


def _arrays(b, h, kv, s, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, d).astype(np.float32),
            rng.randn(b, s, kv, d).astype(np.float32),
            rng.randn(b, s, kv, d).astype(np.float32))


def _edge_lengths(b, kv, s, d, pair):
    """0 (every key masked), 1, one short of, at and one past the first
    split's end, and s; cycled over the b rows."""
    q_dtype, kv_dtype = (getattr(torch, name) for name in PAIRS[pair])
    per_split = decode_module.plan_splits(b, kv, s, d, q_dtype, kv_dtype)[1]
    edges = [0, 1, per_split - 1, per_split, per_split + 1, s]
    return np.asarray([min(max(edges[i % len(edges)], 0), s)
                       for i in range(b)], np.int32)


PAIRS = {"bf16": ("bfloat16", "bfloat16"), "f32": ("float32", "float32"),
         "f32_q_bf16_cache": ("float32", "bfloat16")}


def _torch(arrays, pair):
    q_dtype, kv_dtype = (getattr(torch, name) for name in PAIRS[pair])
    q, k, v = (torch.as_tensor(a) for a in arrays)
    return q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype)


def _pallas(q, k, v, lengths, group):
    """The JAX Pallas kernel in interpret mode, on the same (rounded)
    values, K/V repeated to the query heads (it takes the MHA layout)."""
    cast = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    k = np.repeat(k.float().numpy(), group, axis=2)
    v = np.repeat(v.float().numpy(), group, axis=2)
    return np.asarray(jax_ops.decode_attention(
        jnp.asarray(q.float().numpy(), cast), jnp.asarray(k, cast),
        jnp.asarray(v, cast), jnp.asarray(lengths), interpret=True),
        np.float32)


def _assert_close(actual, expected, pair):
    tol = TOL[PAIRS[pair][0]]
    np.testing.assert_allclose(actual.float().numpy(), np.asarray(expected),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("group", [1, 2, 3, 4, 5, 6, 7, 8, 12])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_route_emulation_matches_pallas_kernel_and_plain_version(pair,
                                                                 group):
    """Every group size (12: two head blocks), lengths 0, 1, at the first
    split's edges and at s; 300 keys cut into 5 ranges of 64 that merge in
    a cluster."""
    b, kv, s, d = 6, 2, 300, 64
    q, k, v = _torch(_arrays(b, kv * group, kv, s, d, seed=group), pair)
    assert decode_module.plan_splits(b, kv, s, d, q.dtype, k.dtype)[0] == 5
    lengths = _edge_lengths(b, kv, s, d, pair)
    out = emulate_route(q, k, v, torch.as_tensor(lengths))
    assert out.dtype == q.dtype
    _assert_close(out, _pallas(q, k, v, lengths, group), pair)
    _assert_close(out, ref.decode_attention_ref(
        q, k, v, torch.as_tensor(lengths)).float(), pair)


@pytest.mark.parametrize("d", [16, 32, 128, 256])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_route_emulation_at_every_head_dim(pair, d):
    """The other head dims, group 6 (internvl2-26b's), against the plain
    version."""
    b, kv, s = 6, 1, 200
    lengths = _edge_lengths(b, kv, s, d, pair)
    q, k, v = _torch(_arrays(b, 6 * kv, kv, s, d, seed=d), pair)
    _assert_close(emulate_route(q, k, v, torch.as_tensor(lengths)),
                  ref.decode_attention_ref(
                      q, k, v, torch.as_tensor(lengths)).float(), pair)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 129, 1000])
@pytest.mark.parametrize("pair", ["bf16", "f32"])
def test_route_emulation_at_split_and_tile_edges(pair, s):
    """One key, a tile and one key either side, and 1000 keys cut into 16
    ranges (past a cluster: the combine launch's merge, the same formula),
    against the plain version."""
    b, kv, d = 6, 1, 64
    lengths = _edge_lengths(b, kv, s, d, pair)
    q, k, v = _torch(_arrays(b, 4, kv, s, d, seed=s), pair)
    _assert_close(emulate_route(q, k, v, torch.as_tensor(lengths)),
                  ref.decode_attention_ref(
                      q, k, v, torch.as_tensor(lengths)).float(), pair)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_serving_shape_is_one_launch():
    """Phase 5's serving rows and every family phase 24 serves, at 8
    slots over 384 keys (and Whisper's 1500-frame cross-attention): a plan
    of at most one cluster's splits, one kernel."""
    smoke = _chip_smoke()
    b, s = smoke.SERVE_SLOTS, smoke.DECODE_SERVING_KEYS
    names = {name for _, name, _, _ in smoke.DECODE_SERVING}
    names |= {name for name, _, _, _ in smoke.SERVE_ZOO}
    shapes = []
    for name in sorted(names):
        cfg = configs.get_arch(name)
        if cfg.num_heads and cfg.head_dim:
            shapes.append((b, cfg.num_kv_heads, s, cfg.head_dim))
    shapes.append((b, 8, 1500, 64))                    # Whisper's cross
    assert len(shapes) >= 5
    for shape in shapes:
        for q_dtype, kv_dtype in decode_module.PAIRS:
            splits, _ = decode_module.plan_splits(*shape, q_dtype, kv_dtype)
            assert 1 <= splits <= decode_module.CLUSTER_MAX, shape
            assert len(decode_module.kernel_names(q_dtype, kv_dtype,
                                                  *shape)) == 1


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("b,kv,s,d", [
    (1, 1, 1, 16), (1, 1, 4096, 256), (8, 8, 384, 128), (8, 8, 576, 64),
    (64, 2, 2048, 64), (8, 2, 4096, 64), (1, 8, 4096, 128), (16, 2, 8, 64),
    (4, 2, 300, 32), (2, 1, 65537, 64), (33, 1, 999, 16), (16, 1, 999, 16)])
def test_split_plan_covers_the_cache_and_routes_by_shape(b, kv, s, d, pair):
    """The splits are whole tiles, cover s with none empty, and a plan of
    more splits than a cluster holds takes the combine launch, which only
    a small batch's long cache needs."""
    q_dtype, kv_dtype = (getattr(torch, name) for name in PAIRS[pair])
    splits, per_split = decode_module.plan_splits(b, kv, s, d, q_dtype,
                                                  kv_dtype)
    tile = decode_module.TILE_ELEMS // d
    assert per_split % tile == 0
    assert splits * per_split >= s > (splits - 1) * per_split
    names = decode_module.kernel_names(q_dtype, kv_dtype, b, kv, s, d)
    assert names[0] == ("decode_mma_kernel" if pair == "bf16"
                        else "decode_split_kernel")
    if splits > decode_module.CLUSTER_MAX:
        assert names[1:] == ["decode_combine_kernel"]
        target = decode_module.TARGET_BLOCKS[decode_module.route(
            q_dtype, kv_dtype)]
        assert b * kv * 2 * decode_module.CLUSTER_MAX < target
    else:
        assert names[1:] == []


def test_split_plan_is_a_function_of_the_shapes_alone():
    """No lengths, no device: the shapes and dtypes give the plan; at the
    zoo's serving shape (8 slots, 384 keys, 8 KV heads, d 128) each route
    takes the split count its sweep on the card found fastest."""
    assert decode_module.plan_splits.__code__.co_varnames[:6] == (
        "b", "kv", "s", "d", "q_dtype", "kv_dtype")
    expected = {"bf16": (3, 128), "f32": (4, 96), "f32_q_bf16_cache": (6, 64)}
    for pair, plan in expected.items():
        dtypes = [getattr(torch, name) for name in PAIRS[pair]]
        assert decode_module.plan_splits(8, 8, 384, 128, *dtypes) == plan
