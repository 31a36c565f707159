"""repro_torch.kernels: the plain versions of decode attention, V-trace,
flash attention and the SSD scan against the JAX oracles and the Pallas
kernels (interpret mode), GQA, ragged and fully masked inputs, the window
without ``causal``, and the CPU/CUDA dispatch rules.  The CUDA kernels
themselves are tested on a card in test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (TARGET_BLOCKS, TILE_ELEMS,
                                                  DecodeAttention,
                                                  decode_attention,
                                                  plan_splits)
from repro_torch.models import attention

RNG = np.random.RandomState(42)
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 1e-4


def _inputs(b, h, kv, s, d, lengths=None):
    q = RNG.randn(b, h, d).astype(np.float32)
    k = RNG.randn(b, s, kv, d).astype(np.float32)
    v = RNG.randn(b, s, kv, d).astype(np.float32)
    if lengths is None:
        lengths = RNG.randint(1, s + 1, b)
    return q, k, v, np.asarray(lengths, np.int32)


def _torch(arrays, dtype: str, device="cpu"):
    q, k, v, lengths = arrays
    cast = TORCH_DTYPES[dtype]
    return (torch.as_tensor(q).to(device, cast),
            torch.as_tensor(k).to(device, cast),
            torch.as_tensor(v).to(device, cast),
            torch.as_tensor(lengths).to(device))


def _jax(arrays, dtype: str, repeat: int = 1):
    q, k, v, lengths = arrays
    if repeat > 1:           # the JAX caller expands GQA K/V (_repeat_kv)
        k, v = np.repeat(k, repeat, axis=2), np.repeat(v, repeat, axis=2)
    cast = getattr(jnp, dtype)
    return (jnp.asarray(q, cast), jnp.asarray(k, cast), jnp.asarray(v, cast),
            jnp.asarray(lengths))


def _assert_close(actual, expected, dtype: str):
    np.testing.assert_allclose(
        np.asarray(actual.float() if torch.is_tensor(actual) else
                   np.asarray(actual, np.float32), np.float32),
        np.asarray(expected, np.float32),
        atol=_tol(dtype), rtol=_tol(dtype))


# =============================================== plain version against JAX
@pytest.mark.parametrize("b,h,s,d", [
    (1, 1, 512, 64),
    (2, 4, 1024, 64),
    (1, 8, 512, 128),
    (4, 2, 2048, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_matches_jax_oracle_sweep(b, h, s, d, dtype):
    """At the shapes of test_kernels.py::test_decode_attention_sweep."""
    arrays = _inputs(b, h, h, s, d)
    out = ref.decode_attention_ref(*_torch(arrays, dtype))
    _assert_close(out, jax_ref.decode_attention_ref(*_jax(arrays, dtype)),
                  dtype)


@pytest.mark.parametrize("b,h,s,d", [
    (8, 2, 8, 16),
    (8, 4, 16, 32),
    (4, 2, 8, 32),
    (64, 4, 8, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_matches_pallas_kernel_serve_shapes(b, h, s, d, dtype):
    """Against the Pallas kernel itself (interpret mode) at the serve
    shapes: ring-length caches and mixed lengths — full rings, mid-prefix
    rows and length-1 pad/restart rows."""
    lengths = np.full((b,), s, np.int32)
    lengths[1::3] = RNG.randint(2, s, len(lengths[1::3]))
    lengths[2::3] = 1
    arrays = _inputs(b, h, h, s, d, lengths)
    out = ref.decode_attention_ref(*_torch(arrays, dtype))
    expected = jax_ops.decode_attention(*_jax(arrays, dtype),
                                        block_k=min(512, s), interpret=True)
    _assert_close(out, expected, dtype)


@pytest.mark.parametrize("h,kv", [(4, 2), (8, 1), (4, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_gqa_indexes_kv_heads_like_repeated_kv(h, kv, dtype):
    """Query head i reads KV head i // (h // kv): the same output as the
    reference's call on K/V repeated to the full head count."""
    arrays = _inputs(3, h, kv, 40, 32)
    out = ref.decode_attention_ref(*_torch(arrays, dtype))
    expected = jax_ref.decode_attention_ref(*_jax(arrays, dtype,
                                                  repeat=h // kv))
    _assert_close(out, expected, dtype)


@pytest.mark.parametrize("s", [1, 7, 1000])
def test_decode_ref_ragged_cache_and_fully_masked_rows(s):
    """Any s >= 1 (the Pallas kernel needs s % block_k == 0); a row whose
    prefix masks every key (length 0) gets the mean of V, never NaN."""
    lengths = np.asarray([0, s, max(s // 2, 1), 0], np.int32)
    arrays = _inputs(4, 4, 2, s, 64, lengths)
    out = ref.decode_attention_ref(*_torch(arrays, "float32"))
    expected = jax_ref.decode_attention_ref(*_jax(arrays, "float32",
                                                  repeat=2))
    _assert_close(out, expected, "float32")
    v = arrays[2]
    mean_v = np.repeat(v.mean(axis=1), 2, axis=1)          # (b, h, d)
    np.testing.assert_allclose(out[0].numpy(), mean_v[0], atol=1e-5)
    assert torch.isfinite(out).all()


# ================================================= the kernel's split plan
@pytest.mark.parametrize("b,kv,s,d,splits", [
    # the serving shapes (fig17's policy, up to 64 rows): one launch
    (1, 2, 8, 64, 1), (16, 2, 8, 64, 1), (64, 2, 8, 64, 1),
    (1, 1, 1, 64, 1),                     # one key
    (64, 2, 2048, 64, 5),                 # the long cache
    (64, 2, 4096, 64, 5),
    (4, 2, 1000, 64, 16),                 # s not a multiple of the tile
    (2, 2, 700, 256, 44),
    (2, 8, 4096, 128, 32),
    (1, 1, 100_000, 64, 521),
    (1024, 2, 2048, 64, 1),               # b x kv fills the card alone
])
def test_plan_splits_covers_the_cache_in_whole_tiles(b, kv, s, d, splits):
    """From shapes alone: whole key tiles a split, none empty, together
    covering s; blocks enough to fill the card twice over or more (a tile
    a split when the cache is short), or one split when the rows alone
    reach the target or the cache is one tile."""
    got, keys = plan_splits(b, kv, s, d)
    tile = TILE_ELEMS // d
    assert got == splits
    assert keys % tile == 0 and keys >= tile
    assert (got - 1) * keys < s <= got * keys
    tiles = -(-s // tile)
    if b * kv >= TARGET_BLOCKS or tiles == 1:
        assert got == 1
    else:   # a tile a split, or at least half the target's blocks
        assert b * kv * got >= min(TARGET_BLOCKS // 2, b * kv * tiles)


def _split_decode(q, k, v, lengths, splits, keys_per_split, warps=4):
    """The kernel's algorithm in f32 torch ops: each split streams its key
    range in tiles, each tile cut among ``warps`` online softmaxes (spread
    evenly when the tile is short), the warps merged, then the splits'
    partials (m, l, acc) merged by m* = max m_i, out = sum e^(m_i - m*)
    acc_i / max(sum e^(m_i - m*) l_i, 1e-30).  A split past the valid
    prefix is the empty partial (-1e30, 0, 0)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    group, tile = h // kv, TILE_ELEMS // d
    q, k, v = q.float(), k.float(), v.float()
    out = torch.empty(b, h, d)
    for row in range(b):
        length = int(lengths[row])
        masked = length < 1
        n_keys = s if masked else min(length, s)
        for head in range(h):
            kvh = head // group
            parts = []
            for split in range(splits):
                begin = split * keys_per_split
                end = min(begin + keys_per_split, n_keys)
                states = [(torch.tensor(-1e30), torch.tensor(0.0),
                           torch.zeros(d)) for _ in range(warps)]
                for key0 in range(begin, end, tile):
                    tile_len = min(tile, end - key0)
                    per_warp = -(-tile_len // warps)
                    for w in range(warps):
                        j0 = key0 + w * per_warp
                        j1 = min(j0 + per_warp, key0 + tile_len)
                        if j1 <= j0:
                            continue
                        keys = slice(j0, j1)
                        sc = (k[row, keys, kvh] @ q[row, head]) * d ** -0.5
                        if masked:
                            sc = torch.full_like(sc, -1e30)
                        m, l, acc = states[w]
                        m_new = torch.maximum(m, sc.max())
                        a = torch.exp(m - m_new)
                        p = torch.exp(sc - m_new)
                        states[w] = (m_new, l * a + p.sum(),
                                     acc * a + p @ v[row, keys, kvh])
                parts.append(_merge(states))
            m, l, acc = _merge(parts)
            out[row, head] = acc / torch.clamp(l, min=1e-30)
    return out


def _merge(states):
    """(m*, sum e^(m_i - m*) l_i, sum e^(m_i - m*) acc_i)."""
    m = torch.stack([st[0] for st in states]).max()
    weights = [torch.exp(st[0] - m) for st in states]
    return (m, sum(w * st[1] for w, st in zip(weights, states)),
            sum(w * st[2] for w, st in zip(weights, states)))


@pytest.mark.parametrize("s,lengths", [
    # b 8 x kv 2 rows: 64-key splits, the last one ragged
    (300, [0, 30, 64, 65, 63, 128, 300, 1]),
    (300, [0, 0, 0, 0, 0, 0, 0, 0]),
    # one 64-key tile
    (8, [8, 1, 0, 5, 8, 8, 3, 0]),
    (65, [65, 64, 0, 1, 2, 33, 64, 10]),
])
def test_split_partials_and_combine_match_the_oracles(s, lengths):
    """Per-split partials and their merge (the kernel's two launches),
    emulated on the CPU, against the plain version and the JAX oracle:
    lengths inside the first split, at split edges, past s's last tile and
    0 (the mean of V; every split non-empty then, all at m = -1e30)."""
    b, h, kv, d = 8, 4, 2, 64
    splits, keys = plan_splits(b, kv, s, d)
    arrays = _inputs(b, h, kv, s, d, lengths)
    q, k, v, lens = _torch(arrays, "float32")
    out = _split_decode(q, k, v, lens, splits, keys)
    expected = ref.decode_attention_ref(q, k, v, lens)
    np.testing.assert_allclose(out.numpy(), expected.numpy(), atol=1e-5,
                               rtol=1e-5)
    oracle = jax_ref.decode_attention_ref(*_jax(arrays, "float32",
                                                repeat=h // kv))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=1e-5,
                               rtol=1e-5)
    assert torch.isfinite(out).all()


def test_split_emulation_exercises_several_splits_and_empty_ones():
    """The shapes above really cut the cache: several splits, some of them
    past a row's valid prefix."""
    splits, keys = plan_splits(8, 2, 300, 64)
    assert splits == 5 and keys == 64
    assert plan_splits(8, 2, 65, 64) == (2, 64)
    assert plan_splits(8, 2, 8, 64) == (1, 64)


# ============================================================ dispatch rules
def test_cpu_tensors_take_the_plain_version_without_launching():
    arrays = _torch(_inputs(2, 4, 2, 16, 32), "float32")
    before = decode_attention.launches
    np.testing.assert_array_equal(ops.decode_attention(*arrays).numpy(),
                                  ref.decode_attention_ref(*arrays).numpy())
    assert decode_attention.launches == before


def test_kernel_wrapper_raises_on_cpu_tensors():
    kernel = DecodeAttention()
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*_torch(_inputs(2, 4, 2, 16, 32), "float32"))
    assert kernel.launches == 0


@pytest.mark.parametrize("backend,expected", [
    ("auto", "ref"), ("ref", "ref"), ("grouped", "grouped")])
def test_decode_backend_resolution_on_cpu(backend, expected):
    assert attention._decode_backend(backend, torch.device("cpu")) == expected


def test_decode_backend_kernel_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        attention._decode_backend("kernel", torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown"):
        attention._decode_backend("jnp", torch.device("cpu"))
    assert (attention._decode_backend("auto", torch.device("cuda"))
            == "kernel")


# ======================================================== V-trace, plain version
VTRACE_TOL = 1e-5      # f32 sums over T <= 100 terms, each of order 1


def _vtrace_inputs(T, B, seed):
    """Time-major (T, B) f32 inputs with rhos both below and above the clip
    and discounts that include zeros (episode ends)."""
    rng = np.random.RandomState(seed)
    values = rng.randn(T, B).astype(np.float32)
    next_values = rng.randn(T, B).astype(np.float32)
    rewards = rng.randn(T, B).astype(np.float32)
    discounts = (rng.rand(T, B) * 0.99).astype(np.float32)
    discounts[rng.rand(T, B) < 0.1] = 0.0
    rhos = (np.abs(rng.randn(T, B)) + 0.1).astype(np.float32)
    return values, next_values, rewards, discounts, rhos


def _assert_vtrace_close(out, expected):
    for a, e in zip(out, expected):
        np.testing.assert_allclose(np.asarray(a), np.asarray(e),
                                   atol=VTRACE_TOL, rtol=VTRACE_TOL)


@pytest.mark.parametrize("T,B", [(16, 128), (64, 256), (100, 128), (20, 16)])
@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 1.5)])
def test_vtrace_ref_matches_jax_oracle_and_pallas_kernel(T, B, clips):
    """At the shapes of test_kernels.py::test_vtrace_sweep and the IMPALA
    learner's (T 20, B 16): against the JAX oracle and against the Pallas
    kernel itself in interpret mode."""
    clip_rho, clip_c = clips
    arrays = _vtrace_inputs(T, B, seed=T * 1000 + B)
    out = ref.vtrace_ref(*map(torch.as_tensor, arrays), clip_rho=clip_rho,
                         clip_c=clip_c)
    jax_args = tuple(map(jnp.asarray, arrays))
    _assert_vtrace_close(out, jax_ref.vtrace_ref(
        *jax_args, clip_rho=clip_rho, clip_c=clip_c))
    _assert_vtrace_close(out, jax_ops.vtrace(
        *jax_args, clip_rho=clip_rho, clip_c=clip_c, block_b=min(128, B),
        interpret=True))


@pytest.mark.parametrize("T,B", [(20, 37), (1, 5), (7, 1)])
def test_vtrace_ref_ragged_batch_matches_jax_oracle(T, B):
    """Any B and T >= 1 (the Pallas kernel asserts B % block_b == 0, so a
    ragged B is held against the JAX oracle alone)."""
    arrays = _vtrace_inputs(T, B, seed=B)
    out = ref.vtrace_ref(*map(torch.as_tensor, arrays))
    _assert_vtrace_close(out, jax_ref.vtrace_ref(*map(jnp.asarray, arrays)))


@pytest.mark.parametrize("T,B", [(20, 16), (33, 31), (1, 5), (64, 1)])
def test_vtrace_ref_on_batch_major_views_equals_contiguous_copies(T, B):
    """The IMPALA learner passes the (T, B) transposes of its (B, T)
    sequences; the plain version gives the same bits on them as on
    contiguous copies."""
    arrays = _vtrace_inputs(T, B, seed=T + B)
    views = tuple(torch.as_tensor(np.ascontiguousarray(a.T)).transpose(0, 1)
                  for a in arrays)
    assert all(x.stride() == (1, T) for x in views if T > 1 and B > 1)
    copies = tuple(x.contiguous() for x in views)
    for a, e in zip(ref.vtrace_ref(*views, clip_rho=0.8, clip_c=1.5),
                    ref.vtrace_ref(*copies, clip_rho=0.8, clip_c=1.5)):
        np.testing.assert_array_equal(a.numpy(), e.numpy())


def test_vtrace_cpu_tensors_take_the_plain_version_without_launching():
    from repro_torch.kernels.vtrace import vtrace as vtrace_kernel
    tensors = tuple(map(torch.as_tensor, _vtrace_inputs(20, 16, seed=3)))
    before = vtrace_kernel.launches
    vs, adv = ops.vtrace(*tensors, clip_rho=0.9, clip_c=0.7)
    vs_ref, adv_ref = ref.vtrace_ref(*tensors, clip_rho=0.9, clip_c=0.7)
    np.testing.assert_array_equal(vs.numpy(), vs_ref.numpy())
    np.testing.assert_array_equal(adv.numpy(), adv_ref.numpy())
    assert vtrace_kernel.launches == before


def test_vtrace_kernel_wrapper_raises_on_cpu_tensors():
    from repro_torch.kernels.vtrace import VTrace
    kernel = VTrace()
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*map(torch.as_tensor, _vtrace_inputs(4, 3, seed=0)))
    assert kernel.launches == 0


# ==================================================== flash attention, plain
FLASH_SWEEP = [(1, 1, 128, 128, 64), (2, 2, 256, 256, 64),
               (1, 4, 256, 512, 128), (2, 1, 512, 512, 32)]
FLASH_MASKS = [(True, None), (True, 64), (False, None)]


def _flash_arrays(b, h, kv, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32),
            rng.randn(b, kv, sk, d).astype(np.float32),
            rng.randn(b, kv, sk, d).astype(np.float32))


def _flash_torch(arrays, dtype):
    return tuple(torch.as_tensor(a).to(TORCH_DTYPES[dtype]) for a in arrays)


def _flash_jax(arrays, dtype, repeat=1):
    q, k, v = arrays
    if repeat > 1:
        k, v = np.repeat(k, repeat, axis=1), np.repeat(v, repeat, axis=1)
    return tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))


@pytest.mark.parametrize(
    "b,h,sq,sk,d,causal,window",
    [shape + mask for shape in FLASH_SWEEP for mask in FLASH_MASKS
     if mask[0] or shape[2] == shape[3]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_jax_oracle_sweep(b, h, sq, sk, d, causal, window,
                                            dtype):
    """At the shapes and masks of test_kernels.py::test_flash_attention_sweep
    (which leaves out non-causal cross shapes)."""
    arrays = _flash_arrays(b, h, h, sq, sk, d, seed=sq + sk + d)
    out = ops.flash_attention(*_flash_torch(arrays, dtype), causal=causal,
                              window=window)
    expected = jax_ref.flash_attention_ref(*_flash_jax(arrays, dtype),
                                           causal=causal, window=window)
    _assert_close(out, expected, dtype)


@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_ref_matches_pallas_kernel(causal, window):
    """Against the Pallas kernel itself (interpret mode), one 128 x 128
    block per head."""
    arrays = _flash_arrays(1, 2, 2, 128, 128, 64, seed=5)
    out = ref.flash_attention_ref(*_flash_torch(arrays, "float32"),
                                  causal=causal, window=window)
    expected = jax_ops.flash_attention(*_flash_jax(arrays, "float32"),
                                       causal=causal, window=window,
                                       interpret=True)
    _assert_close(out, expected, "float32")


@pytest.mark.parametrize("h,kv", [(4, 2), (8, 1), (4, 4)])
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_ref_gqa_indexes_kv_heads_like_repeated_kv(h, kv, causal,
                                                         window):
    """Query head i reads KV head i // (h // kv), with a ragged sq = sk =
    100 (the Pallas kernel needs multiples of 128)."""
    arrays = _flash_arrays(2, h, kv, 100, 100, 32, seed=h * 10 + kv)
    out = ref.flash_attention_ref(*_flash_torch(arrays, "float32"),
                                  causal=causal, window=window)
    expected = jax_ref.flash_attention_ref(
        *_flash_jax(arrays, "float32", repeat=h // kv), causal=causal,
        window=window)
    _assert_close(out, expected, "float32")


def test_flash_window_applies_only_with_causal():
    """The port follows the JAX oracle and the model: without ``causal``
    the window is not applied.  The Pallas kernel applies it either way,
    so on the same inputs it gives another answer."""
    arrays = _flash_arrays(1, 2, 2, 128, 128, 64, seed=7)
    tensors = _flash_torch(arrays, "float32")
    windowed = ops.flash_attention(*tensors, causal=False, window=8)
    np.testing.assert_array_equal(
        windowed.numpy(), ops.flash_attention(*tensors, causal=False).numpy())
    _assert_close(windowed, jax_ref.flash_attention_ref(
        *_flash_jax(arrays, "float32"), causal=False, window=8), "float32")
    pallas = jax_ops.flash_attention(*_flash_jax(arrays, "float32"),
                                     causal=False, window=8, interpret=True)
    assert np.abs(np.asarray(pallas) - windowed.numpy()).max() > 0.1


def test_flash_cpu_tensors_take_the_plain_version_without_launching():
    from repro_torch.kernels.flash_attention import flash_attention
    tensors = _flash_torch(_flash_arrays(1, 4, 2, 16, 16, 32, seed=1),
                           "float32")
    before = flash_attention.launches
    np.testing.assert_array_equal(
        ops.flash_attention(*tensors, window=4).numpy(),
        ref.flash_attention_ref(*tensors, window=4).numpy())
    assert flash_attention.launches == before


def test_flash_kernel_wrapper_raises_on_cpu_tensors():
    from repro_torch.kernels.flash_attention import FlashAttention
    kernel = FlashAttention()
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*_flash_torch(_flash_arrays(1, 2, 2, 8, 8, 32, seed=0),
                             "float32"))
    assert kernel.launches == 0


def test_flash_ops_takes_transposed_views_like_contiguous_copies():
    """The model passes (b, s, heads, d) tensors as (b, heads, s, d) views;
    the result equals the call on contiguous copies."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.as_tensor(rng.randn(2, 96, heads, 32).astype(np.float32))
               for heads in (4, 2, 2))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert not any(t.is_contiguous() for t in views)
    out = ops.flash_attention(*views, causal=True, window=40)
    expected = ops.flash_attention(*(t.contiguous() for t in views),
                                   causal=True, window=40)
    np.testing.assert_array_equal(out.numpy(), expected.numpy())


def _tf32_rna(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: add half of the 13 dropped
    bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b with TF32 operands and f32 sums: one pass (hi.hi) or three
    (lo.hi + hi.lo + hi.hi, lo = tf32(x - tf32(x))), as the kernels'
    ``mma3`` runs them; products of TF32 values are exact in f32.

    This models the operands' rounding only.  The sums here round to
    nearest; the tensor core's own accumulation does not, which is why the
    flash kernel sums each key tile's P.V from zero and adds it to O in
    f32.  That hazard is not modelled on the CPU: the card tests and
    ``chip_smoke.py`` phase 2, at the scoring path's shape, guard it."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


@pytest.mark.parametrize("d", [32, 64, 128])
def test_three_tf32_passes_hold_causal_attention_to_the_f32_tolerance(d):
    """The precision argument for the tensor-core kernels: causal attention
    (unit-normal q, k, v, 384 keys) with both products in three TF32
    passes stays within the f32 tolerance of an f64 computation; one pass
    does not."""
    rng = np.random.RandomState(d)
    q, k, v = (torch.as_tensor(rng.randn(2, 384, d).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(384, 384, dtype=torch.bool).tril()

    def attend(matmul, dtype):
        scores = matmul((q * d ** -0.5).to(dtype),
                        k.transpose(1, 2).to(dtype))
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        return matmul(torch.softmax(scores, dim=-1), v.to(dtype))

    exact = attend(torch.matmul, torch.float64)
    errors = {passes: (attend(lambda a, b: _tf32_matmul(a, b, passes),
                              torch.float32).double() - exact).abs().max()
              .item() for passes in (1, 3)}
    assert errors[3] <= _tol("float32"), errors
    assert errors[1] > _tol("float32"), errors


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -10, 3.0e-3],
                     dtype=torch.float32)
    rounded = _tf32_rna(x)
    np.testing.assert_array_equal(
        rounded[:5].numpy(),
        np.float32([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10),
                    1.0 + 2 ** -10]))
    assert abs(rounded[5].item() / 3.0e-3 - 1) <= 2 ** -11


# ============================================================ SSD, plain
SSD_TOL = 1e-5     # of the output's largest magnitude, as test_ssd_scan_sweep


def _ssd_arrays(b, s, h, p, n, seed, h0=False):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, s, h, p), np.abs(rng.randn(b, s, h)) * 0.1 + 0.01,
              -(np.abs(rng.randn(h)) + 0.5), rng.randn(b, s, n),
              rng.randn(b, s, n)]
    if h0:
        arrays.append(rng.randn(b, h, n, p))
    return [a.astype(np.float32) for a in arrays]


def _assert_scaled_close(actual, expected, tol=SSD_TOL):
    expected = np.asarray(expected)
    scale = np.abs(expected).max() + 1.0
    np.testing.assert_allclose(np.asarray(actual) / scale, expected / scale,
                               atol=tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 256, 2, 32, 16, 64),
    (2, 512, 4, 64, 32, 128),
    (1, 512, 2, 64, 64, 256),
])
def test_ssd_ref_matches_jax_oracle_sweep(b, s, h, p, n, chunk):
    """At the shapes of test_kernels.py::test_ssd_scan_sweep, the final
    state included."""
    arrays = _ssd_arrays(b, s, h, p, n, seed=s + n)
    y, final = ops.ssd_scan(*map(torch.as_tensor, arrays), chunk=chunk)
    y_ref, final_ref = jax_ref.ssd_scan_ref(*map(jnp.asarray, arrays), chunk)
    _assert_scaled_close(y, y_ref)
    _assert_scaled_close(final, final_ref)


def test_ssd_ref_matches_pallas_kernel():
    """Against the Pallas kernel itself (interpret mode), which returns y
    only; the final state is held against the JAX oracle."""
    arrays = _ssd_arrays(1, 128, 2, 32, 16, seed=3)
    y, final = ref.ssd_scan_ref(*map(torch.as_tensor, arrays), 64)
    jax_args = tuple(map(jnp.asarray, arrays))
    _assert_scaled_close(y, jax_ops.ssd_scan(*jax_args, chunk=64,
                                             interpret=True))
    _assert_scaled_close(final, jax_ref.ssd_scan_ref(*jax_args, 64)[1])


def test_ssd_ref_with_initial_state_matches_jax():
    from repro.models.ssm import ssd_chunked
    arrays = _ssd_arrays(2, 128, 3, 16, 8, seed=4, h0=True)
    y, final = ops.ssd_scan(*map(torch.as_tensor, arrays[:5]), chunk=32,
                            h0=torch.as_tensor(arrays[5]))
    y_ref, final_ref = ssd_chunked(*map(jnp.asarray, arrays[:5]), 32,
                                   h0=jnp.asarray(arrays[5]))
    _assert_scaled_close(y, y_ref)
    _assert_scaled_close(final, final_ref)


def test_ssd_cpu_tensors_take_the_plain_version_without_launching():
    from repro_torch.kernels.ssd_scan import ssd_scan
    tensors = tuple(map(torch.as_tensor, _ssd_arrays(1, 64, 2, 16, 8, 5)))
    before = ssd_scan.launches
    y, final = ops.ssd_scan(*tensors, chunk=32)
    y_ref, final_ref = ref.ssd_scan_ref(*tensors, 32)
    np.testing.assert_array_equal(y.numpy(), y_ref.numpy())
    np.testing.assert_array_equal(final.numpy(), final_ref.numpy())
    assert ssd_scan.launches == before


def test_ssd_kernel_wrapper_raises_on_cpu_tensors():
    from repro_torch.kernels.ssd_scan import SSDScan
    kernel = SSDScan()
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*map(torch.as_tensor, _ssd_arrays(1, 64, 2, 16, 8, 6)), 32)
    assert kernel.launches == 0


def test_tensor_core_probe_variants_edit_the_committed_sources(monkeypatch):
    """Each variant of ``scripts/tensor_core_probe.py`` (one part of a
    tensor-core kernel taken out, timed on the card) still finds the text
    it edits in the committed sources, and changes it."""
    import importlib.util
    import pathlib
    import sys
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script adds to it
    path = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
            / "tensor_core_probe.py")
    spec = importlib.util.spec_from_file_location("tensor_core_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    csrc = probe.build.CSRC
    for kernel, variants in probe.VARIANTS.items():
        for name in variants:
            texts = probe.variant_sources(kernel, name)
            assert f"{kernel}.cu" in texts
            assert any(text != (csrc / file).read_text()
                       for file, text in texts.items()), (kernel, name)


def test_latency_probe_variants_edit_the_committed_sources(monkeypatch):
    """Each variant of ``scripts/latency_probe.py`` (decode attention and
    V-trace with clock64() marks, a phase run twice, or a part taken out,
    timed on the card) still finds every text it edits in the committed
    sources, exactly once, and changes them."""
    import importlib.util
    import pathlib
    import sys
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script adds to it
    path = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
            / "latency_probe.py")
    spec = importlib.util.spec_from_file_location("latency_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    for kernel, variants in probe.VARIANTS.items():
        committed = (probe.build.CSRC / f"{kernel}.cu").read_text()
        for name in variants:
            text = probe.variant_sources(kernel, name)[f"{kernel}.cu"]
            assert text != committed, (kernel, name)
            marks = probe.MARKS.get((kernel, name))
            if marks is not None:   # one mark per span's end, and the start
                assert all(f"PROBE_MARK({i})" in text
                           for i in range(len(marks))), (kernel, name)


# -------------------------------------------- gradients through the kernels
class _PlainKernel:
    """Stands in for a kernel wrapper on the CPU: the plain version's
    forward, counted like a launch."""

    def __init__(self, forward):
        self.forward = forward
        self.launches = 0

    def __call__(self, *args):
        self.launches += 1
        return self.forward(*args)


def _route_as_on_the_card(monkeypatch):
    """CPU tensors dispatched as ``ops`` dispatches the card's, each
    kernel's forward replaced by its plain version: what is left to test is
    the dispatch and each ``torch.autograd.Function``'s backward."""
    from repro_torch.kernels import flash_attention as flash_module
    from repro_torch.kernels import ssd_scan as ssd_module
    flash = _PlainKernel(lambda q, k, v, causal, window:
                         ref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window))
    ssd = _PlainKernel(lambda x, dt, A, B, C, chunk, h0:
                       ref.ssd_scan_ref(x, dt, A, B, C, chunk, h0=h0))
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_flash", flash)
    monkeypatch.setattr(flash_module, "flash_attention", flash)
    monkeypatch.setattr(ops, "_ssd", ssd)
    monkeypatch.setattr(ssd_module, "ssd_scan", ssd)
    return flash, ssd


@pytest.fixture
def card_route(monkeypatch):
    return _route_as_on_the_card(monkeypatch)


def _grads(outputs, inputs, seed=0):
    """Gradients of sum(out * g) over every output, with fixed random g."""
    rng = np.random.RandomState(seed)
    loss = sum((out * torch.as_tensor(rng.randn(*out.shape),
                                      dtype=out.dtype)).sum()
               for out in outputs)
    return torch.autograd.grad(loss, inputs)


def _assert_grads_equal(actual, expected):
    assert len(actual) == len(expected) > 0
    for a, b in zip(actual, expected):
        assert a is not None and a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("h,kv,sq,sk,causal,window", [
    (4, 4, 64, 64, True, None), (4, 4, 96, 96, True, 24),
    (8, 2, 64, 64, True, None), (8, 2, 48, 80, False, None)],
    ids=["causal", "window", "gqa", "cross"])
def test_flash_function_backward_equals_plain_autograd(card_route, h, kv, sq,
                                                       sk, causal, window):
    """With grad on, ops.flash_attention goes through
    FlashAttentionFunction: one forward launch, and a backward (the plain
    recompute) whose gradients equal plain autograd's exactly."""
    flash, _ = card_route
    inputs = [torch.as_tensor(a).requires_grad_()
              for a in _flash_arrays(2, h, kv, sq, sk, 32, seed=sq + h)]
    out = ops.flash_attention(*inputs, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    grads = _grads([out], inputs)
    assert flash.launches == 1                     # the forward only
    plain = ref.flash_attention_ref(*inputs, causal=causal, window=window)
    torch.testing.assert_close(out, plain, atol=0, rtol=0)
    _assert_grads_equal(grads, _grads([plain], inputs))


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
def test_ssd_function_backward_equals_plain_autograd(card_route, with_h0):
    """With grad on, ops.ssd_scan goes through SSDScanFunction; the
    gradient of a loss over both outputs (y and the final state) with
    respect to x, dt, A, B, C and h0 equals plain autograd's exactly."""
    _, ssd = card_route
    inputs = [torch.as_tensor(a).requires_grad_()
              for a in _ssd_arrays(2, 128, 3, 16, 8, seed=9, h0=with_h0)]
    h0 = inputs[5] if with_h0 else None
    y, final = ops.ssd_scan(*inputs[:5], chunk=32, h0=h0)
    assert type(y.grad_fn).__name__ == "SSDScanFunctionBackward"
    grads = _grads([y, final], inputs)
    assert ssd.launches == 1
    plain = ref.ssd_scan_ref(*inputs[:5], 32, h0=h0)
    _assert_grads_equal(grads, _grads(plain, inputs))


def test_functions_return_grads_only_where_inputs_need_them(card_route):
    q, k, v = map(torch.as_tensor, _flash_arrays(1, 2, 2, 16, 16, 32, 1))
    q.requires_grad_()
    (dq,) = _grads([ops.flash_attention(q, k, v)], [q])
    assert dq is not None and k.grad is None and v.grad is None
    x, dt, A, B, C = map(torch.as_tensor, _ssd_arrays(1, 64, 2, 16, 8, 2))
    B.requires_grad_()
    (dB,) = _grads(ops.ssd_scan(x, dt, A, B, C, chunk=32), [B])
    assert dB.shape == B.shape and bool(dB.abs().sum() > 0)


def test_kernels_run_without_autograd_when_no_grad_is_wanted(card_route):
    """Without grad mode, or with no input that requires grad, ops calls
    the kernel itself: no Function, nothing saved for a backward."""
    flash, ssd = card_route
    q, k, v = map(torch.as_tensor, _flash_arrays(1, 2, 2, 16, 16, 32, 3))
    assert ops.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(q.requires_grad_(), k, v).grad_fn is None
    arrays = list(map(torch.as_tensor, _ssd_arrays(1, 64, 2, 16, 8, 4)))
    y, final = ops.ssd_scan(*arrays, chunk=32)
    assert y.grad_fn is None and final.grad_fn is None
    assert (flash.launches, ssd.launches) == (2, 1)


def _all_grads(params, loss_fn):
    from repro_torch import tree
    leaves, treedef = tree.flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    return torch.autograd.grad(loss_fn(tree.unflatten(treedef, leaves)),
                               leaves)


def test_q_sequence_grads_through_the_functions_equal_the_plain_route(
        monkeypatch):
    """The transformer policy's full-sequence Q values (the learner's
    forward pass, slice 5): every parameter's gradient through
    FlashAttentionFunction equals the plain route's."""
    from repro_torch.policies import TransformerPolicyConfig, network
    cfg = TransformerPolicyConfig(num_layers=2, d_model=64, num_heads=4,
                                  num_kv_heads=2, head_dim=32, d_ff=128,
                                  window=8)
    arch = network.make_arch(cfg, 3)
    params = network.init(torch.Generator().manual_seed(0), arch, 50, 3,
                          device="cpu")
    obs = torch.as_tensor(np.random.RandomState(3).rand(5, 8, 50) < 0.2,
                          dtype=torch.float32)
    weights = torch.as_tensor(np.random.RandomState(4).randn(5, 8, 3),
                              dtype=torch.float32)

    def loss(p):
        return (network.q_sequence(p, arch, obs) * weights).sum()

    plain = _all_grads(params, loss)
    flash, _ = _route_as_on_the_card(monkeypatch)
    routed = _all_grads(params, loss)
    assert flash.launches == arch.num_layers
    _assert_grads_equal(routed, plain)


def test_reduced_zamba2_grads_through_the_functions_equal_the_plain_route(
        monkeypatch):
    """A reduced Zamba2 forward to the logits (Mamba2 layers, a
    shared-attention site and a tail): every parameter's gradient through
    both Functions equals the plain route's; one forward launch per site
    and per layer."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import layers, transformer
    cfg = dataclasses.replace(configs.reduced(configs.get_arch(
        "zamba2-1.2b")), num_layers=3, hybrid_attn_every=2)
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 64))
    weights = torch.as_tensor(np.random.RandomState(1).randn(
        2, 64, cfg.padded_vocab_size), dtype=torch.float32)

    def loss(p):
        feats, _ = transformer.forward_features(p, cfg, {"tokens": tokens})
        logits = layers.unembed(transformer.unembed_table(p, cfg), feats)
        return (logits * weights).sum()

    plain = _all_grads(params, loss)
    flash, ssd = _route_as_on_the_card(monkeypatch)
    routed = _all_grads(params, loss)
    assert flash.launches == cfg.num_layers // cfg.hybrid_attn_every
    assert ssd.launches == cfg.num_layers
    _assert_grads_equal(routed, plain)
