"""repro_torch.kernels: the plain decode attention against the JAX oracle
and the Pallas kernel (interpret mode), GQA, ragged and fully masked
caches, and the CPU/CUDA dispatch rules.  The CUDA kernel itself is tested
on a card in test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (DecodeAttention,
                                                  decode_attention)
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
