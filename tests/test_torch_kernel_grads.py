"""repro_torch.kernels: the plain versions of the backward kernels
(``ref.flash_attention_bwd_ref``, ``ref.ssd_scan_bwd_ref``) and of the rows'
log-sum-exp that the flash forward writes for its backward
(``ref.flash_attention_lse_ref``), against ``jax.vjp`` of the JAX package's
functions (``repro.kernels.ref.flash_attention_ref``, with K/V repeated to
the query heads and dK/dV summed over each group, and
``repro.models.ssm.ssd_chunked``) and against torch autograd of the plain
forwards; then the autograd Functions' dispatch with the backward kernels
stood in by their plain versions.  The CUDA kernels themselves are held to
these plain versions on a card in test_torch_cuda.py and chip_smoke.py's
phase 13."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ops, ref
from torch_card_route import route_as_on_the_card

# The forward tests' scaled rule (test_torch_kernels.py): max |a - e| over
# (max |e| + 1) <= TOL, in f32 at these small sizes: the same f32 math in
# another order.  bf16 inputs are held to their f32 gradients at BF16_TOL.
TOL = 1e-5
BF16_TOL = 2e-2


def _numpy(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(t, dtype=np.float32)


def _assert_scaled_close(actual, expected, tol=TOL):
    actual, expected = _numpy(actual), _numpy(expected)
    scale = np.abs(expected).max() + 1.0
    np.testing.assert_allclose(actual / scale, expected / scale, atol=tol)


# ------------------------------------------------------- flash attention
# (label, b, h, kv, sq, sk, d, causal, window)
FLASH_CASES = [
    ("causal", 2, 4, 4, 64, 64, 32, True, None),
    ("window", 2, 4, 4, 96, 96, 32, True, 24),
    ("gqa", 2, 8, 2, 64, 64, 16, True, None),
    ("gqa_window", 1, 6, 2, 80, 80, 64, True, 16),
    ("noncausal_cross", 2, 4, 2, 48, 80, 32, False, None),
    ("no_key_rows", 1, 2, 2, 300, 100, 16, True, 64),
]
FLASH_IDS = [case[0] for case in FLASH_CASES]


def _flash_case(b, h, kv, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d), (b, h, sq, d))]


def _flash_bwd(q, k, v, g, causal, window):
    """The plain backward on the plain forward's output and lse."""
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    return ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal=causal,
                                       window=window)


@pytest.mark.parametrize("label,b,h,kv,sq,sk,d,causal,window", FLASH_CASES,
                         ids=FLASH_IDS)
def test_flash_bwd_ref_matches_jax_vjp(label, b, h, kv, sq, sk, d, causal,
                                       window):
    q, k, v, g = _flash_case(b, h, kv, sq, sk, d, seed=sq + h)
    group = h // kv

    def attend(q, k, v):
        return jax_ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
    _, vjp = jax.vjp(attend, jnp.asarray(q),
                     jnp.asarray(np.repeat(k, group, axis=1)),
                     jnp.asarray(np.repeat(v, group, axis=1)))
    dq_j, dk_j, dv_j = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    dk_j = dk_j.reshape(b, kv, group, sk, d).sum(axis=2)
    dv_j = dv_j.reshape(b, kv, group, sk, d).sum(axis=2)
    dq, dk, dv = _flash_bwd(*map(torch.as_tensor, (q, k, v, g)), causal,
                            window)
    for actual, expected in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        _assert_scaled_close(actual, expected)


@pytest.mark.parametrize("label,b,h,kv,sq,sk,d,causal,window", FLASH_CASES,
                         ids=FLASH_IDS)
def test_flash_bwd_ref_matches_torch_autograd(label, b, h, kv, sq, sk, d,
                                              causal, window):
    q, k, v, g = map(torch.as_tensor,
                     _flash_case(b, h, kv, sq, sk, d, seed=sq + kv))
    inputs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ref.flash_attention_ref(*inputs, causal=causal, window=window)
    expected = torch.autograd.grad(out, inputs, g)
    for actual, e in zip(_flash_bwd(q, k, v, g, causal, window), expected):
        _assert_scaled_close(actual, e)


def test_flash_lse_ref_is_the_masked_scores_logsumexp():
    """The log-sum-exp, f64 in numpy, of the masked scores; a row that sees
    no key gets -1e30 (the mask value; f32 drops log sk)."""
    b, h, kv, sq, sk, d, window = 1, 4, 2, 300, 100, 16, 64
    q, k, _, _ = _flash_case(b, h, kv, sq, sk, d, seed=3)
    lse = ref.flash_attention_lse_ref(torch.as_tensor(q), torch.as_tensor(k),
                                      causal=True, window=window)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                       np.repeat(k, h // kv, axis=1)) * d ** -0.5
    qi, ki = np.arange(sq)[:, None], np.arange(sk)[None, :]
    kept = (qi >= ki) & (qi - ki < window)
    scores = np.where(kept, scores, -1e30)
    top = scores.max(axis=-1, keepdims=True)
    expected = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True))
                )[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    empty = ~kept.any(axis=-1)
    assert empty.sum() == sq - (sk - 1 + window)
    np.testing.assert_allclose(lse.numpy()[..., ~empty], expected[..., ~empty],
                               rtol=1e-6, atol=1e-5)
    assert (lse.numpy()[..., empty] == np.float32(-1e30)).all()


@pytest.mark.parametrize("label,b,h,kv,sq,sk,d,causal,window",
                         [FLASH_CASES[3], FLASH_CASES[5]],
                         ids=[FLASH_IDS[3], FLASH_IDS[5]])
def test_flash_bwd_ref_bfloat16(label, b, h, kv, sq, sk, d, causal, window):
    """bf16 q, k, v and grad_out: grads in bf16, within BF16_TOL of the
    f32 gradients of the same (rounded) values."""
    arrays = _flash_case(b, h, kv, sq, sk, d, seed=7)
    q, k, v, g = (torch.as_tensor(a).to(torch.bfloat16) for a in arrays)
    grads = _flash_bwd(q, k, v, g, causal, window)
    expected = _flash_bwd(q.float(), k.float(), v.float(), g.float(), causal,
                          window)
    for actual, e in zip(grads, expected):
        assert actual.dtype == torch.bfloat16
        _assert_scaled_close(actual, e, BF16_TOL)


# --------------------------------------------------------------- SSD scan
# (label, b, s, h, p, n, chunk, with h0)
SSD_CASES = [
    ("h0", 2, 128, 3, 16, 8, 32, True),
    ("chunk_100", 1, 300, 2, 16, 24, 100, False),
    ("chunk_100_h0", 1, 300, 2, 16, 24, 100, True),
    ("one_chunk", 1, 64, 2, 32, 16, 64, True),
    ("odd_state", 2, 96, 2, 16, 12, 32, False),
]
SSD_IDS = [case[0] for case in SSD_CASES]


def _ssd_case(b, s, h, p, n, seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, s, h, p), np.abs(rng.randn(b, s, h)) * 0.1 + 0.01,
              -(np.abs(rng.randn(h)) + 0.5), rng.randn(b, s, n),
              rng.randn(b, s, n), rng.randn(b, h, n, p),
              rng.randn(b, s, h, p), rng.randn(b, h, n, p)]
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("label,b,s,h,p,n,chunk,with_h0", SSD_CASES,
                         ids=SSD_IDS)
def test_ssd_bwd_ref_matches_jax_vjp(label, b, s, h, p, n, chunk, with_h0):
    x, dt, A, B, C, h0, gy, gf = _ssd_case(b, s, h, p, n, seed=s + n)
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
    grads = ref.ssd_scan_bwd_ref(
        *map(torch.as_tensor, (x, dt, A, B, C)),
        torch.as_tensor(h0) if with_h0 else None,
        torch.as_tensor(gy), torch.as_tensor(gf), chunk)
    assert (grads[5] is None) == (not with_h0)
    for actual, e in zip(grads, expected):
        assert tuple(actual.shape) == e.shape
        _assert_scaled_close(actual, e)


@pytest.mark.parametrize("label,b,s,h,p,n,chunk,with_h0", SSD_CASES,
                         ids=SSD_IDS)
def test_ssd_bwd_ref_matches_torch_autograd(label, b, s, h, p, n, chunk,
                                            with_h0):
    x, dt, A, B, C, h0, gy, gf = map(torch.as_tensor,
                                     _ssd_case(b, s, h, p, n, seed=s + p))
    inputs = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    if with_h0:
        inputs.append(h0.clone().requires_grad_())
    y, final = ref.ssd_scan_ref(*inputs[:5], chunk,
                                h0=inputs[5] if with_h0 else None)
    expected = torch.autograd.grad((y, final), inputs, (gy, gf))
    grads = ref.ssd_scan_bwd_ref(x, dt, A, B, C, h0 if with_h0 else None,
                                 gy, gf, chunk)
    for actual, e in zip(grads, expected):
        _assert_scaled_close(actual, e)


def test_ssd_bwd_ref_bfloat16():
    """bf16 x, B and C: their grads in bf16, the others f32, within
    BF16_TOL of the f32 gradients of the same (rounded) values."""
    x, dt, A, B, C, h0, gy, gf = map(torch.as_tensor,
                                     _ssd_case(1, 300, 2, 16, 24, seed=11))
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    grads = ref.ssd_scan_bwd_ref(x, dt, A, B, C, h0, gy, gf, 100)
    expected = ref.ssd_scan_bwd_ref(x.float(), dt, A, B.float(), C.float(),
                                    h0, gy, gf, 100)
    dtypes = [torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
              torch.bfloat16, torch.float32]
    for actual, e, dtype in zip(grads, expected, dtypes):
        assert actual.dtype == dtype
        _assert_scaled_close(actual, e, BF16_TOL)


# ------------------------------- the Functions, backward kernels stood in
@pytest.fixture
def card_route(monkeypatch):
    return route_as_on_the_card(monkeypatch)


def test_flash_function_backward_launches_the_backward_once(card_route):
    """One forward launch (with the rows' log-sum-exp) and one backward
    launch per call, the backward handed the forward's output and lse;
    gradients as the plain backward gives them."""
    q, k, v, g = map(torch.as_tensor, _flash_case(1, 4, 2, 40, 40, 32, 5))
    seen = []
    bwd = card_route.flash_bwd.fn

    def spy(q_, k_, v_, out, lse, grad_out, causal, window):
        seen.append((out, lse, causal, window))
        return bwd(q_, k_, v_, out, lse, grad_out, causal, window)
    card_route.flash_bwd.fn = spy
    inputs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*inputs, causal=True, window=8)
    grads = torch.autograd.grad(out, inputs, g)
    assert card_route.flash.launches == card_route.flash_bwd.launches == 1
    (saved_out, lse, causal, window), = seen
    assert torch.equal(saved_out, out.detach()) and (causal, window) == (
        True, 8)
    torch.testing.assert_close(lse, ref.flash_attention_lse_ref(
        q, k, causal=True, window=8), atol=0, rtol=0)
    for actual, e in zip(grads, _flash_bwd(q, k, v, g, True, 8)):
        torch.testing.assert_close(actual, e, atol=0, rtol=0)


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, False),
                                   (False, False, True), (False, True, True)],
                         ids=["q", "k", "v", "kv"])
def test_flash_function_grads_only_where_needed(card_route, needs):
    arrays = _flash_case(1, 2, 1, 16, 16, 16, 6)
    inputs = [torch.as_tensor(a).requires_grad_(need)
              for a, need in zip(arrays[:3], needs)]
    out = ops.flash_attention(*inputs)
    out.backward(torch.as_tensor(arrays[3]))
    assert card_route.flash_bwd.launches == 1
    for t, need in zip(inputs, needs):
        assert (t.grad is not None) == need


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
def test_ssd_function_backward_launches_the_backward_once(card_route,
                                                          with_h0):
    """One forward launch that keeps its scratch and one backward launch
    per call; a loss on y alone still backs the final state's gradient with
    zeros; gradients as the plain backward gives them."""
    x, dt, A, B, C, h0, gy, _ = map(torch.as_tensor,
                                    _ssd_case(1, 64, 2, 16, 8, 12))
    inputs = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    if with_h0:
        inputs.append(h0.clone().requires_grad_())
    y, _ = ops.ssd_scan(*inputs[:5], chunk=32,
                        h0=inputs[5] if with_h0 else None)
    grads = torch.autograd.grad(y, inputs, gy)
    assert card_route.ssd.launches == card_route.ssd_bwd.launches == 1
    expected = ref.ssd_scan_bwd_ref(x, dt, A, B, C, h0 if with_h0 else None,
                                    gy, torch.zeros_like(h0), 32)
    for actual, e in zip(grads, expected):
        torch.testing.assert_close(actual, e, atol=0, rtol=0)


@pytest.mark.parametrize("which", ["x", "dt", "A", "B", "C", "h0"])
def test_ssd_function_grads_only_where_needed(card_route, which):
    names = ["x", "dt", "A", "B", "C", "h0"]
    arrays = _ssd_case(1, 64, 2, 16, 8, 13)
    inputs = [torch.as_tensor(a).requires_grad_(name == which)
              for name, a in zip(names, arrays[:6])]
    y, final = ops.ssd_scan(*inputs[:5], chunk=32, h0=inputs[5])
    ((y * torch.as_tensor(arrays[6])).sum()
     + (final * torch.as_tensor(arrays[7])).sum()).backward()
    assert card_route.ssd_bwd.launches == 1
    for name, t in zip(names, inputs):
        assert (t.grad is not None) == (name == which), name


def test_backward_kernel_wrappers_raise_on_cpu_tensors():
    """The backward wrappers launch on CUDA tensors only: on CPU tensors
    they raise (``ops`` never hands them any) and count nothing."""
    from repro_torch.kernels.flash_attention import FlashAttentionBwd
    from repro_torch.kernels.ssd_scan import SSDScanBwd
    q, k, v, g = map(torch.as_tensor, _flash_case(1, 2, 2, 8, 8, 16, 14))
    flash = FlashAttentionBwd()
    with pytest.raises(ValueError, match="CUDA"):
        flash(q, k, v, q, torch.zeros(1, 2, 8), g)
    x, dt, A, B, C, h0, gy, gf = map(torch.as_tensor,
                                     _ssd_case(1, 64, 2, 16, 8, 15))
    ssd = SSDScanBwd()
    with pytest.raises(ValueError, match="CUDA"):
        ssd(x, dt, A, B, C, None, (), gy, gf, 32)
    assert flash.launches == ssd.launches == 0
