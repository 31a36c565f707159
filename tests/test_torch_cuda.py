"""repro_torch on a card: the CUDA decode-attention, V-trace,
flash-attention and SSD-scan kernels against their plain versions, their
argument checks and launch counts, the kernel-backed engine against the
plain one, an IMPALA learner step that launches V-trace once and syncs
once, the reduced Zamba2 and Mamba2 scoring steps on the kernels against
the same steps on the plain versions, gradients through flash attention
and the SSD scan (their autograd Functions) against the plain route's, and
a DQN learner step that syncs once and matches the CPU's.

Every test here is marked ``cuda`` and skips without a CUDA device; this
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (HEAD_DIMS, decode_attention,
                                                  plan_splits)
from repro_torch.kernels.vtrace import vtrace
from repro_torch.policies import PolicyEngine, TransformerPolicyConfig, network
from repro_torch.policies.actors import _WindowBuffer

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
OBS_SHAPE = (10, 5)
WINDOW = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, kv, s, d, dtype, device, lengths=None, seed=0):
    rng = np.random.RandomState(seed)
    if lengths is None:
        lengths = rng.randint(1, s + 1, b)
    arrays = (rng.randn(b, h, d), rng.randn(b, s, kv, d),
              rng.randn(b, s, kv, d))
    q, k, v = (torch.as_tensor(a, dtype=torch.float32).to(device, dtype)
               for a in arrays)
    return q, k, v, torch.as_tensor(np.asarray(lengths, np.int32),
                                    device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d", [
    (1, 4, 2, 8, 64), (8, 4, 2, 8, 64), (64, 4, 2, 8, 64),
    (4, 2, 2, 2048, 32), (2, 8, 8, 512, 128), (3, 4, 2, 1000, 64),
    (2, 8, 2, 300, 16), (2, 8, 2, 700, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, b, h, kv, s, d, dtype):
    lengths = np.random.RandomState(1).randint(1, s + 1, b)
    lengths[0] = 0                                    # a fully masked row
    q, k, v, lens = _inputs(b, h, kv, s, d, dtype, cuda_device, lengths)
    before = decode_attention.launches
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, h, d)
    expected = ref.decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(out.float(), expected.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _edge_lengths(b, s, keys_per_split, seed):
    """Lengths at the split plan's edges: 0 (every key masked), inside the
    first split, one short of, at and one past a split's end, s, 1, and
    random ones after those."""
    rng = np.random.RandomState(seed)
    edges = [0, max(keys_per_split // 2, 1), keys_per_split - 1,
             keys_per_split, keys_per_split + 1, s, 1]
    lengths = np.asarray(edges + list(rng.randint(0, s + 1, b)), np.int64)
    return np.clip(lengths[:b], 0, s + 1)


def _check_decode(q, k, v, lens):
    before = decode_attention.launches
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    expected = ref.decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(out.float(), expected.float(),
                               atol=TOL[q.dtype], rtol=TOL[q.dtype])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(8, 1), (8, 63), (8, 64), (8, 65),
                                 (8, 127), (8, 128), (8, 129), (8, 2048),
                                 (8, 4096), (64, 447), (64, 448), (64, 449),
                                 (64, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_split_edges_match_plain_version(cuda_device, b, s, dtype):
    """Caches of one key, one tile and one split, one key either side of
    them, and long ones cut into several splits; lengths at the splits'
    edges, inside the first split and 0, so later splits are empty."""
    _, keys = plan_splits(b, 2, s, 64)
    q, k, v, lens = _inputs(b, 4, 2, s, 64, dtype, cuda_device,
                            _edge_lengths(b, s, keys, seed=s))
    _check_decode(q, k, v, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4, 8, 12])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_groups_and_head_dims_match_plain_version(cuda_device, group,
                                                         d, dtype):
    """1 to 8 query heads a KV head in one block, 12 in two; every head
    dim (16-byte rows of 2 bf16 chunks at d = 16); 300 keys over several
    splits."""
    b, kv, s = 8, 2, 300
    _, keys = plan_splits(b, kv, s, d)
    q, k, v, lens = _inputs(b, kv * group, kv, s, d, dtype, cuda_device,
                            _edge_lengths(b, s, keys, seed=d + group))
    _check_decode(q, k, v, lens)


@pytest.mark.cuda
def test_kernel_second_call_reads_no_stale_partials(cuda_device):
    """A call at another split plan, on partials the allocator hands back,
    matches the plain version, and the first call repeats exactly."""
    big = _inputs(64, 4, 2, 2048, 64, torch.float32, cuda_device, seed=1)
    first = _check_decode(*big)
    small = _inputs(4, 8, 2, 300, 32, torch.float32, cuda_device,
                    _edge_lengths(4, 300, 64, seed=2))
    _check_decode(*small)
    assert torch.equal(decode_attention(*big), first)


@pytest.mark.cuda
def test_kernel_rejects_unsupported_inputs(cuda_device):
    assert 48 not in HEAD_DIMS
    q, k, v, lens = _inputs(2, 4, 2, 8, 48, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, k, v, lens)
    q, k, v, lens = _inputs(2, 4, 3, 8, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="shapes"):
        decode_attention(q, k, v, lens)
    q, k, v, lens = _inputs(2, 4, 2, 8, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, v, lens.long())
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                         k, v, lens)


@pytest.mark.cuda
def test_kernel_engine_matches_plain_engine(cuda_device):
    """Four episodes for 3x the window with a mid-run restart: the engine on
    the kernel and the engine on the plain version give equal actions and
    Q-values within 1e-4, and every decode batch launches the kernel once
    per layer."""
    cfg = TransformerPolicyConfig(num_layers=2, d_model=32, num_heads=4,
                                  num_kv_heads=2, head_dim=16, d_ff=64,
                                  window=WINDOW)
    arch = network.make_arch(cfg, 3)
    params = network.init(torch.Generator().manual_seed(0), arch, 50, 3,
                          device=cuda_device)
    engines = [PolicyEngine(arch, OBS_SHAPE, 3, num_slots=4, backend=b,
                            device=cuda_device) for b in ("kernel", "ref")]
    rng = np.random.RandomState(9)
    bufs = [_WindowBuffer(WINDOW, OBS_SHAPE) for _ in range(4)]
    before = decode_attention.launches
    for t in range(3 * WINDOW):
        if t == 6:
            bufs[2].reset()
        for b in bufs:
            b.push(rng.rand(*OBS_SHAPE).astype(np.float32))
        windows = np.stack([b.window_array() for b in bufs])
        positions = [b.t for b in bufs]
        (a0, q0), (a1, q1) = (e.select_with_q(params, list("abcd"), windows,
                                              positions) for e in engines)
        np.testing.assert_array_equal(a0, a1)
        np.testing.assert_allclose(q0, q1, atol=1e-4, rtol=1e-4)
    decode_batches = engines[0].stats()["decode_batches"]
    assert decode_batches > 0
    assert decode_attention.launches - before == \
        decode_batches * arch.num_layers


# ------------------------------------------------------------------ V-trace
VTRACE_TOL = 1e-4      # f32, as in chip_smoke.py
VTRACE_SHAPES = [(20, 16), (16, 128), (64, 256), (100, 128), (20, 37), (1, 5),
                 (100, 16384)]
# around the kernel's 32-row chunks and 32-column tiles, and its 16-byte
# copies (a multiple of 4 along the contiguous axis, or not)
VTRACE_T = [1, 31, 32, 33, 64, 65, 100, 1000]
VTRACE_B = [1, 15, 16, 17, 31, 32, 33, 16391]


def _vtrace_inputs(T, B, device, seed=0, batch_major=False):
    """rhos below and above the clips, discounts with zeros (episode ends);
    with ``batch_major``, (T, B) transposes of contiguous (B, T) tensors."""
    rng = np.random.RandomState(seed)
    discounts = rng.rand(T, B) * 0.99
    discounts[rng.rand(T, B) < 0.1] = 0.0
    arrays = (rng.randn(T, B), rng.randn(T, B), rng.randn(T, B), discounts,
              np.abs(rng.randn(T, B)) + 0.1)
    if batch_major:
        return tuple(torch.as_tensor(np.ascontiguousarray(a.T),
                                     dtype=torch.float32,
                                     device=device).transpose(0, 1)
                     for a in arrays)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", VTRACE_SHAPES)
@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 1.5)])
def test_vtrace_kernel_matches_plain_version(cuda_device, T, B, clips):
    tensors = _vtrace_inputs(T, B, cuda_device, seed=T + B)
    before = vtrace.launches
    vs, adv = vtrace(*tensors, *clips)
    torch.cuda.synchronize()
    assert vtrace.launches == before + 1
    vs_ref, adv_ref = ref.vtrace_ref(*tensors, clip_rho=clips[0],
                                     clip_c=clips[1])
    torch.testing.assert_close(vs, vs_ref, atol=VTRACE_TOL, rtol=VTRACE_TOL)
    torch.testing.assert_close(adv, adv_ref, atol=VTRACE_TOL,
                               rtol=VTRACE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T", VTRACE_T)
@pytest.mark.parametrize("B", VTRACE_B)
@pytest.mark.parametrize("batch_major", [False, True])
def test_vtrace_kernel_layouts_match_plain_version(cuda_device, T, B,
                                                   batch_major):
    """Both layouts (time-major, and the learner's transposed (B, T)
    sequences), with both clip settings; the outputs come in the inputs'
    layout."""
    tensors = _vtrace_inputs(T, B, cuda_device, seed=T * B,
                             batch_major=batch_major)
    for clips in ((1.0, 1.0), (0.8, 1.5)):
        vs, adv = vtrace(*tensors, *clips)
        torch.cuda.synchronize()
        vs_ref, adv_ref = ref.vtrace_ref(*tensors, clip_rho=clips[0],
                                         clip_c=clips[1])
        torch.testing.assert_close(vs, vs_ref, atol=VTRACE_TOL,
                                   rtol=VTRACE_TOL)
        torch.testing.assert_close(adv, adv_ref, atol=VTRACE_TOL,
                                   rtol=VTRACE_TOL)
        for out in (vs, adv):
            assert out.shape == (T, B)
            assert (out.transpose(0, 1) if batch_major else out
                    ).is_contiguous()


@pytest.mark.cuda
def test_vtrace_ops_launches_on_cuda_tensors(cuda_device):
    tensors = _vtrace_inputs(20, 16, cuda_device)
    before = vtrace.launches
    ops.vtrace(*tensors)
    assert vtrace.launches == before + 1


@pytest.mark.cuda
def test_vtrace_kernel_rejects_unsupported_inputs(cuda_device):
    tensors = _vtrace_inputs(8, 4, cuda_device)
    before = vtrace.launches
    with pytest.raises(ValueError, match="float32"):
        vtrace(tensors[0].bfloat16(), *tensors[1:])
    # not dense along either axis
    with pytest.raises(ValueError, match="layout"):
        vtrace(*(t[:, ::2] for t in tensors))
    # the two layouts mixed
    with pytest.raises(ValueError, match="layout"):
        vtrace(tensors[0].t().contiguous().t(), *tensors[1:])
    with pytest.raises(ValueError, match="shape"):
        vtrace(tensors[0][:, :3].contiguous(), *tensors[1:])
    with pytest.raises(ValueError, match="shape"):
        vtrace(*(t[:0] for t in tensors))
    assert vtrace.launches == before


def _impala_learner(device, num_batches):
    from repro_torch.agents.impala import IMPALAConfig, make_learner
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import Catch
    from repro_torch.replay import ReplaySample, SampleInfo

    cfg = IMPALAConfig()
    B, T = cfg.batch_size, cfg.sequence_length
    rng = np.random.RandomState(0)
    data = {"observation": (rng.rand(B, T, 10, 5) < 0.1).astype(np.float32),
            "action": rng.randint(0, 3, (B, T)).astype(np.int32),
            "reward": rng.randint(-1, 2, (B, T)).astype(np.float32),
            "discount": (rng.rand(B, T) > 0.1).astype(np.float32),
            "mask": np.ones((B, T), np.float32),
            "behavior_logits": rng.randn(B, T, 3).astype(np.float32)}
    sample = ReplaySample(SampleInfo(np.arange(B), np.ones(B)), data)
    return make_learner(make_environment_spec(Catch()), cfg,
                        iter([sample] * num_batches),
                        torch.Generator().manual_seed(0), device=device)


@pytest.mark.cuda
def test_impala_learner_step_launches_vtrace_once(cuda_device):
    learner = _impala_learner(cuda_device, 2)
    before = vtrace.launches
    metrics = learner.step()
    assert vtrace.launches == before + 1
    assert metrics["learner_steps"] == 1.0
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.cuda
def test_impala_learner_step_syncs_only_for_its_metrics(cuda_device):
    """The batch upload, the forward and backward passes and Adam queue
    without waiting for the device; the one copy of the metrics to the host
    is the step's only sync."""
    learner = _impala_learner(cuda_device, 3)
    learner.step()                  # builds and loads the kernel
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                learner.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "synchronizing CUDA" in str(w.message)]
        assert len(syncs) == 1, syncs


# ---------------------------------------------------------- flash attention
FLASH_CASES = [   # (b, h, kv, sq, sk, d): test_kernels.py's sweep, ragged, GQA
    (1, 1, 1, 128, 128, 64), (2, 2, 2, 256, 256, 64),
    (1, 4, 4, 256, 512, 128), (2, 1, 1, 512, 512, 32),
    (2, 4, 4, 100, 100, 64), (1, 2, 2, 70, 200, 32),
    (2, 8, 2, 256, 256, 64), (1, 4, 1, 300, 300, 128)]
FLASH_MASKS = [(True, None), (True, 64), (False, None)]


def _flash_inputs(b, h, kv, sq, sk, d, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.as_tensor(rng.randn(*shape), dtype=torch.float32
                                 ).to(device, dtype)
                 for shape in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,sq,sk,d", FLASH_CASES)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda_device, b, h, kv, sq, sk, d,
                                            causal, window, dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_inputs(b, h, kv, sq, sk, d, dtype, cuda_device,
                            seed=sq + sk + d)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    expected = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), expected.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_matches_plain_version_at_the_scoring_shape(cuda_device):
    """One shared-attention site of Zamba2-1.2B's scoring step: b 4, h 32,
    kv 32, s 2048, d 64, causal, no window, float32."""
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_inputs(4, 32, 32, 2048, 2048, 64, torch.float32,
                            cuda_device, seed=6)
    torch.testing.assert_close(
        flash_attention(q, k, v, True, None),
        ref.flash_attention_ref(q, k, v, causal=True, window=None),
        atol=TOL[torch.float32], rtol=0)


@pytest.mark.cuda
def test_flash_kernel_rows_past_the_last_key_get_the_mean_of_v(cuda_device):
    """sq > sk with a window: rows i with i - (sk - 1) >= window see no key
    and get the mean of V, as the plain version does."""
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_inputs(1, 2, 2, 300, 100, 64, torch.float32,
                            cuda_device)
    out = flash_attention(q, k, v, True, 64)
    expected = ref.flash_attention_ref(q, k, v, causal=True, window=64)
    torch.testing.assert_close(out, expected, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out[:, :, 200:],
                               v.mean(dim=2, keepdim=True).expand(-1, -1, 100,
                                                                  -1),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_flash_kernel_ignores_the_window_without_causal(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_inputs(2, 4, 2, 128, 128, 64, torch.float32, cuda_device)
    torch.testing.assert_close(flash_attention(q, k, v, False, 8),
                               flash_attention(q, k, v, False, None),
                               atol=0.0, rtol=0.0)


@pytest.mark.cuda
def test_flash_kernel_rejects_unsupported_inputs(cuda_device):
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     flash_attention)
    before = flash_attention.launches
    assert 48 not in HEAD_DIMS
    q, k, v = _flash_inputs(1, 2, 2, 64, 64, 48, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, k, v)
    q, k, v = _flash_inputs(1, 4, 3, 64, 64, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, k, v)
    q, k, v = _flash_inputs(1, 4, 2, 64, 64, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, True, 0)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_flash_ops_launches_on_cuda_tensors(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_inputs(1, 4, 2, 64, 64, 64, torch.float32, cuda_device)
    before = flash_attention.launches
    ops.flash_attention(q, k, v, causal=True, window=None)
    assert flash_attention.launches == before + 1


FLASH_EDGES = [1, 15, 16, 17, 63, 65, 127, 129]   # around the 16-row warp
                                                  # and 64-row/key tiles


@pytest.mark.cuda
@pytest.mark.parametrize("sq", FLASH_EDGES)
@pytest.mark.parametrize("sk", FLASH_EDGES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_at_tile_edges(cuda_device, sq, sk, causal):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_inputs(1, 4, 2, sq, sk, 64, torch.float32, cuda_device,
                            seed=sq * 131 + sk)
    out = flash_attention(q, k, v, causal, None)
    expected = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out, expected, atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_model_layout_views(cuda_device, dtype):
    """The model passes transposed views of (b, s, heads, d) tensors; the
    kernel reads them by their strides and writes its output in the same
    order, equal to the call on contiguous copies."""
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.RandomState(12)
    q, k, v = (torch.as_tensor(rng.randn(2, 200, heads, 64),
                               dtype=torch.float32).to(cuda_device, dtype)
               for heads in (8, 2, 2))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    out = flash_attention(*views, True, 80)
    expected = flash_attention(*(t.contiguous() for t in views), True, 80)
    assert out.shape == (2, 8, 200, 64)
    assert out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, expected)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [65, 100, 130])
def test_flash_kernel_reversed_causal_tiles_with_a_window_across_tiles(
        cuda_device, window):
    """Causal query tiles launch heaviest first; windows that end inside a
    64-key tile, so a tile is cut by the window and by the diagonal."""
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_inputs(2, 4, 4, 300, 300, 64, torch.float32,
                            cuda_device, seed=window)
    torch.testing.assert_close(
        flash_attention(q, k, v, True, window),
        ref.flash_attention_ref(q, k, v, causal=True, window=window),
        atol=TOL[torch.float32], rtol=TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_kernel_pv_reads_the_key_of_each_weight(cuda_device, d):
    """Each query puts almost all its weight on one key, whose V row is
    distinct from every other key's: the output is that key's V row, so a
    wrong order of keys between P and V shows."""
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.RandomState(d)
    sk = d
    target = rng.randint(0, sk, 200)
    k = np.eye(sk, d) * 40.0 * d ** 0.5      # score 40 on the key, 0 elsewhere
    q = np.eye(sk, d)[target]
    v = np.arange(sk)[:, None] + 0.01 * rng.randn(sk, d)
    q, k, v = (torch.as_tensor(a, dtype=torch.float32,
                               device=cuda_device)[None, None]
               for a in (q, k, v))
    out = flash_attention(q, k, v, False, None)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v,
                                                            causal=False),
                               atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])
    torch.testing.assert_close(out[0, 0], v[0, 0, target], atol=1e-3,
                               rtol=0)


@pytest.mark.cuda
def test_policy_q_sequence_through_flash_kernel(cuda_device):
    """Slice 1's policy network reaches full-sequence attention at s = 8,
    window 8, kv = 2, head_dim 64: the kernel route matches the plain one
    and launches once per layer."""
    from unittest import mock
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = TransformerPolicyConfig(num_layers=2, d_model=256, num_heads=4,
                                  num_kv_heads=2, head_dim=64, d_ff=512,
                                  window=8)
    arch = network.make_arch(cfg, 3)
    params = network.init(torch.Generator().manual_seed(0), arch, 50, 3,
                          device=cuda_device)
    obs = torch.as_tensor(np.random.RandomState(3).rand(5, 8, 50) < 0.2,
                          dtype=torch.float32, device=cuda_device)
    before = flash_attention.launches
    q = network.q_sequence(params, arch, obs)
    assert flash_attention.launches == before + arch.num_layers
    with mock.patch.object(ops, "flash_attention", ref.flash_attention_ref):
        q_plain = network.q_sequence(params, arch, obs)
    assert flash_attention.launches == before + arch.num_layers
    torch.testing.assert_close(q, q_plain, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------- SSD scan
# (b, s, h, p, n, chunk): test_kernels.py's sweep, Mamba2's d_state 128, the
# reduced configs' shape, and Zamba2-1.2B's scoring shape
SSD_CASES = [(1, 256, 2, 32, 16, 64), (2, 512, 4, 64, 32, 128),
             (1, 512, 2, 64, 64, 256), (1, 512, 4, 64, 128, 256),
             (2, 64, 32, 16, 16, 32), (1, 300, 3, 16, 24, 100)]
SSD_TOL = 1e-5        # of the output's largest magnitude, as the sweep's
SSD_PATH = (4, 2048, 64, 64, 64, 256)
# At the path's shape A runs down to -64 and the chunk's cumulative decay
# reaches ~1e3, where one f32 ulp is ~1e-4: the plain version's f32
# torch.cumsum carries that into exp(cum_i - cum_j) for the fastest-decaying
# heads (the kernel keeps the sum in f64).
SSD_PATH_TOL = 1e-4


def _ssd_inputs(b, s, h, p, n, device, dtype=torch.float32, seed=0,
                model_like=False, h0=False):
    """The sweep's inputs (dt in 0.01..0.4, A in -0.5..-3), or, with
    ``model_like``, the model's: dt = softplus(N(0, 1) + dt_bias) and
    A = -(1..h), as Zamba2's init gives them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p)
    if model_like:
        bias = np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                                  h))))
        dt = np.logaddexp(rng.randn(b, s, h) + bias, 0.0)
        A = -np.arange(1, h + 1, dtype=np.float64)
    else:
        dt = np.abs(rng.randn(b, s, h)) * 0.1 + 0.01
        A = -(np.abs(rng.randn(h)) + 0.5)
    B, C = rng.randn(b, s, n), rng.randn(b, s, n)

    def t(a, cast=torch.float32):
        return torch.as_tensor(a, dtype=torch.float32).to(device, cast)
    state = t(rng.randn(b, h, n, p)) if h0 else None
    return (t(x, dtype), t(dt), t(A), t(B, dtype), t(C, dtype)), state


def _scaled_err(actual, expected):
    return ((actual - expected).abs().max()
            / (expected.abs().max() + 1.0)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_kernel_matches_plain_version(cuda_device, b, s, h, p, n, chunk,
                                          with_h0):
    from repro_torch.kernels.ssd_scan import ssd_scan
    inputs, h0 = _ssd_inputs(b, s, h, p, n, cuda_device, seed=s + n,
                             h0=with_h0)
    before = ssd_scan.launches
    y, final = ssd_scan(*inputs, chunk, h0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == final.dtype == torch.float32
    assert y.shape == (b, s, h, p) and final.shape == (b, h, n, p)
    y_ref, final_ref = ref.ssd_scan_ref(*inputs, chunk, h0=h0)
    assert _scaled_err(y, y_ref) <= SSD_TOL
    assert _scaled_err(final, final_ref) <= SSD_TOL


# (b, s, h, p, n, chunk): one chunk, 16 chunks, the ragged chunk 100, and
# d_state 128 with several n-tiles of the state
SSD_CHUNKINGS = [(2, 256, 4, 64, 64, 256), (1, 1024, 3, 32, 16, 64),
                 (2, 400, 4, 64, 32, 100), (1, 512, 4, 128, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CHUNKINGS)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_kernel_chunkings(cuda_device, b, s, h, p, n, chunk, with_h0):
    from repro_torch.kernels.ssd_scan import ssd_scan
    inputs, h0 = _ssd_inputs(b, s, h, p, n, cuda_device, seed=s + chunk,
                             h0=with_h0)
    y, final = ssd_scan(*inputs, chunk, h0)
    y_ref, final_ref = ref.ssd_scan_ref(*inputs, chunk, h0=h0)
    assert _scaled_err(y, y_ref) <= SSD_TOL
    assert _scaled_err(final, final_ref) <= SSD_TOL


@pytest.mark.cuda
def test_ssd_kernel_second_call_reads_nothing_stale(cuda_device):
    """The scratch (cumulative sums, scores, chunk states) is written before
    it is read: a call at another shape after a larger one, on memory the
    allocator hands back, matches the plain version, and the first call
    repeats exactly."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    big, _ = _ssd_inputs(2, 1024, 8, 64, 64, cuda_device, seed=1)
    small, h0 = _ssd_inputs(1, 300, 3, 16, 24, cuda_device, seed=2, h0=True)
    first = ssd_scan(*big, 256)
    torch.cuda.synchronize()
    y, final = ssd_scan(*small, 100, h0)
    y_ref, final_ref = ref.ssd_scan_ref(*small, 100, h0=h0)
    assert _scaled_err(y, y_ref) <= SSD_TOL
    assert _scaled_err(final, final_ref) <= SSD_TOL
    again = ssd_scan(*big, 256)
    assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


@pytest.mark.cuda
def test_ssd_kernel_bfloat16_inputs(cuda_device):
    """x, B and C in bf16, the math in f32: the plain version upcasts the
    same bf16 values, so the two agree to f32 rounding."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    inputs, _ = _ssd_inputs(2, 512, 4, 64, 32, cuda_device,
                            dtype=torch.bfloat16)
    y, final = ssd_scan(*inputs, 128)
    y_ref, final_ref = ref.ssd_scan_ref(*inputs, 128)
    assert _scaled_err(y, y_ref) <= SSD_TOL
    assert _scaled_err(final, final_ref) <= SSD_TOL


@pytest.mark.cuda
def test_ssd_kernel_at_the_zamba2_scoring_shape(cuda_device):
    from repro_torch.kernels.ssd_scan import ssd_scan
    b, s, h, p, n, chunk = SSD_PATH
    inputs, _ = _ssd_inputs(b, s, h, p, n, cuda_device, model_like=True)
    y, final = ssd_scan(*inputs, chunk)
    y_ref, final_ref = ref.ssd_scan_ref(*inputs, chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(final).all())
    assert _scaled_err(y, y_ref) <= SSD_PATH_TOL
    assert _scaled_err(final, final_ref) <= SSD_PATH_TOL


@pytest.mark.cuda
def test_ssd_kernel_rejects_unsupported_inputs(cuda_device):
    from repro_torch.kernels.ssd_scan import ssd_scan
    before = ssd_scan.launches
    (x, dt, A, B, C), _ = _ssd_inputs(1, 128, 2, 64, 16, cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        ssd_scan(x.half(), dt, A, B.half(), C.half(), 64)
    with pytest.raises(ValueError, match="dtypes"):
        ssd_scan(x, dt.bfloat16(), A, B, C, 64)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, A, B, C, 48)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, dt, A, B, C, 512)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan(x, dt, A[:1].contiguous(), B, C, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x, dt, A, B.transpose(1, 2).contiguous().transpose(1, 2), C,
                 64)
    (x, dt, A, B, C), _ = _ssd_inputs(1, 128, 2, 48, 16, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_scan(x, dt, A, B, C, 64)
    (x, dt, A, B, C), _ = _ssd_inputs(1, 128, 2, 64, 256, cuda_device)
    with pytest.raises(ValueError, match="d_state"):
        ssd_scan(x, dt, A, B, C, 64)
    assert ssd_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,tail", [("zamba2-1.2b", False),
                                       ("zamba2-1.2b", True),
                                       ("mamba2-780m", False)])
def test_reduced_scoring_step_kernel_route_matches_plain(cuda_device, name,
                                                         tail):
    """make_prefill_step on a reduced config: every SSM layer launches the
    SSD kernel once and every shared-attention site the flash kernel once,
    and the kernel route gives the plain route's actions and logits."""
    import dataclasses
    from unittest import mock
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer

    cfg = configs.reduced(configs.get_arch(name))
    if tail:
        cfg = dataclasses.replace(cfg, num_layers=3, hybrid_attn_every=2)
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device=cuda_device)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 64))
    step = make_prefill_step(cfg)
    flash0, ssd0 = flash_attention.launches, ssd_scan.launches
    out = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    sites = (cfg.num_layers // cfg.hybrid_attn_every
             if cfg.arch_type == "hybrid" else 0)
    assert flash_attention.launches - flash0 == sites
    assert ssd_scan.launches - ssd0 == cfg.num_layers
    with mock.patch.object(ops, "flash_attention", ref.flash_attention_ref), \
            mock.patch.object(ops, "ssd_scan", _plain_ssd_scan):
        plain = step(params, {"tokens": tokens})
    assert flash_attention.launches - flash0 == sites
    assert ssd_scan.launches - ssd0 == cfg.num_layers
    torch.testing.assert_close(out["last_logits"], plain["last_logits"],
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(out["actions"], plain["actions"])


def _plain_ssd_scan(x, dt, A, B, C, *, chunk=256, h0=None):
    return ref.ssd_scan_ref(x, dt, A, B, C, min(chunk, x.shape[1]), h0=h0)


# ------------------------------------------- gradients through the kernels
GRAD_TOL = 1e-4     # of each gradient's largest magnitude (f32 kernels)


def _grads_of(outputs, inputs, seed=0):
    rng = np.random.RandomState(seed)
    loss = sum((out * torch.as_tensor(rng.randn(*out.shape),
                                      dtype=out.dtype, device=out.device)
                ).sum() for out in outputs)
    return torch.autograd.grad(loss, inputs)


def _assert_grads_close(actual, expected, tol=GRAD_TOL):
    assert len(actual) == len(expected) > 0
    for a, b in zip(actual, expected):
        assert a is not None and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert _scaled_err(a, b) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,sq,sk,causal,window", [
    (4, 4, 256, 256, True, None), (4, 4, 300, 300, True, 100),
    (8, 2, 256, 256, True, None), (4, 2, 100, 200, False, None)],
    ids=["causal", "window", "gqa", "cross"])
def test_flash_grads_on_the_card_match_the_plain_route(cuda_device, h, kv,
                                                       sq, sk, causal,
                                                       window):
    """ops.flash_attention on CUDA tensors that require grad: an output
    with a grad_fn, one forward launch, and gradients equal to the plain
    version's (the backward recomputes it)."""
    from repro_torch.kernels.flash_attention import flash_attention
    inputs = [t.requires_grad_() for t in _flash_inputs(
        2, h, kv, sq, sk, 64, torch.float32, cuda_device, seed=sq)]
    before = flash_attention.launches
    out = ops.flash_attention(*inputs, causal=causal, window=window)
    assert out.grad_fn is not None
    grads = _grads_of([out], inputs)
    assert flash_attention.launches == before + 1
    plain = ref.flash_attention_ref(*inputs, causal=causal, window=window)
    _assert_grads_close(grads, _grads_of([plain], inputs))


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_grads_on_the_card_match_the_plain_route(cuda_device, with_h0):
    from repro_torch.kernels.ssd_scan import ssd_scan
    tensors, h0 = _ssd_inputs(2, 512, 4, 64, 32, cuda_device, seed=5,
                              h0=with_h0)
    inputs = [t.requires_grad_() for t in tensors]
    if h0 is not None:
        inputs.append(h0.requires_grad_())
    before = ssd_scan.launches
    y, final = ops.ssd_scan(*inputs[:5], chunk=128, h0=h0)
    assert y.grad_fn is not None and final.grad_fn is not None
    grads = _grads_of([y, final], inputs)
    assert ssd_scan.launches == before + 1
    plain = ref.ssd_scan_ref(*inputs[:5], 128, h0=h0)
    _assert_grads_close(grads, _grads_of(plain, inputs))


def _param_grads(params, loss_fn):
    from repro_torch import tree
    leaves, treedef = tree.flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    return torch.autograd.grad(loss_fn(tree.unflatten(treedef, leaves)),
                               leaves)


@pytest.mark.cuda
def test_q_sequence_grads_through_the_kernel_match_the_plain_route(
        cuda_device):
    """The transformer policy's learner forward at the served width: every
    parameter gets a gradient through the flash kernel, within GRAD_TOL of
    the plain route's; one forward launch per layer."""
    from unittest import mock
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = TransformerPolicyConfig(num_layers=2, d_model=256, num_heads=4,
                                  num_kv_heads=2, head_dim=64, d_ff=512,
                                  window=8)
    arch = network.make_arch(cfg, 3)
    params = network.init(torch.Generator().manual_seed(0), arch, 50, 3,
                          device=cuda_device)
    obs = torch.as_tensor(np.random.RandomState(3).rand(32, 8, 50) < 0.2,
                          dtype=torch.float32, device=cuda_device)
    weights = torch.as_tensor(np.random.RandomState(4).randn(32, 8, 3),
                              dtype=torch.float32, device=cuda_device)

    def loss(p):
        return (network.q_sequence(p, arch, obs) * weights).sum()

    before = flash_attention.launches
    grads = _param_grads(params, loss)
    assert flash_attention.launches == before + arch.num_layers
    with mock.patch.object(ops, "flash_attention", ref.flash_attention_ref):
        plain = _param_grads(params, loss)
    _assert_grads_close(grads, plain)


@pytest.mark.cuda
def test_reduced_zamba2_grads_through_the_kernels_match_the_plain_route(
        cuda_device):
    import dataclasses
    from unittest import mock
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import layers, transformer
    cfg = dataclasses.replace(configs.reduced(configs.get_arch(
        "zamba2-1.2b")), num_layers=3, hybrid_attn_every=2)
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device=cuda_device)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 256))
    weights = torch.as_tensor(np.random.RandomState(1).randn(
        2, 256, cfg.padded_vocab_size), dtype=torch.float32,
        device=cuda_device)

    def loss(p):
        feats, _ = transformer.forward_features(p, cfg, {"tokens": tokens})
        logits = layers.unembed(transformer.unembed_table(p, cfg), feats)
        return (logits * weights).sum()

    flash0, ssd0 = flash_attention.launches, ssd_scan.launches
    grads = _param_grads(params, loss)
    assert flash_attention.launches - flash0 == 1
    assert ssd_scan.launches - ssd0 == cfg.num_layers
    with mock.patch.object(ops, "flash_attention", ref.flash_attention_ref), \
            mock.patch.object(ops, "ssd_scan", _plain_ssd_scan):
        plain = _param_grads(params, loss)
    _assert_grads_close(grads, plain)


# --------------------------------------------------------------------- DQN
@pytest.mark.cuda
def test_dqn_learner_step_syncs_once_and_matches_the_cpu(cuda_device):
    """The DQN learner on the card: each step's one copy to the host (loss,
    step counter, |td| priorities) is its only sync, and after 3 steps from
    the same init on the same batches its params match the CPU learner's."""
    from repro_torch import tree
    from repro_torch.agents import dqn
    from repro_torch.core import make_environment_spec, types
    from repro_torch.envs import Catch
    from repro_torch.replay import ReplaySample, SampleInfo

    rng = np.random.RandomState(0)
    batches = [ReplaySample(
        SampleInfo(np.arange(32) + 32 * i, rng.rand(32) * 0.01 + 1e-4),
        types.Transition((rng.rand(32, 10, 5) < 0.1).astype(np.float32),
                         rng.randint(0, 3, 32).astype(np.int32),
                         rng.randint(-1, 2, 32).astype(np.float32),
                         (rng.rand(32) > 0.2).astype(np.float32),
                         (rng.rand(32, 10, 5) < 0.1).astype(np.float32), ()))
        for i in range(4)]
    cfg = dqn.DQNConfig(batch_size=32)
    spec = make_environment_spec(Catch())
    card, cpu = (dqn.make_learner(spec, cfg, iter(batches),
                                  torch.Generator().manual_seed(0),
                                  priority_update_cb=lambda k, p: None,
                                  device=device)
                 for device in (cuda_device, "cpu"))
    card.step()
    cpu.step()
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                card.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cpu.step()
        syncs = [w for w in caught if "synchronizing CUDA" in str(w.message)]
        assert len(syncs) == 1, [str(w.message) for w in syncs]
    for a, b in zip(tree.leaves(card.state.params),
                    tree.leaves(cpu.state.params)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-5)


# ------------------------------------------ the transformer policy's learner
FLASH_D16_SEQS = [1, 7, 16, 33]


@pytest.mark.cuda
@pytest.mark.parametrize("s", FLASH_D16_SEQS)
@pytest.mark.parametrize("window", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_head_dim_16_matches_plain_version(cuda_device, s,
                                                        window, dtype):
    """d = 16, the reference acceptance preset's head dim: 64-byte f32 and
    32-byte bf16 rows (whole 16-byte copies), two k-steps of S = Q.K^T,
    windows of 4 and 8 that mask whole key groups, GQA 2:1."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
    assert 16 in HEAD_DIMS
    q, k, v = _flash_inputs(3, 4, 2, s, s, 16, dtype, cuda_device,
                            seed=s + window)
    before = flash_attention.launches
    out = flash_attention(q, k, v, True, window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    expected = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), expected.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("s,window", [(10, 4), (16, 8), (33, 4)])
def test_flash_grads_at_head_dim_16_match_the_plain_route(cuda_device, s,
                                                          window):
    """FlashAttentionFunction at d = 16: one forward launch and the plain
    route's gradients."""
    from repro_torch.kernels.flash_attention import flash_attention
    inputs = [t.requires_grad_() for t in _flash_inputs(
        8, 2, 1, s, s, 16, torch.float32, cuda_device, seed=s)]
    before = flash_attention.launches
    out = ops.flash_attention(*inputs, causal=True, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    grads = _grads_of([out], inputs)
    assert flash_attention.launches == before + 1
    plain = ref.flash_attention_ref(*inputs, causal=True, window=window)
    _assert_grads_close(grads, _grads_of([plain], inputs))


def _policy_sequences(batch, T, seed):
    from repro_torch.replay import ReplaySample, SampleInfo
    rng = np.random.RandomState(seed)
    lengths = rng.randint(2, T + 1, batch)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    starts = np.zeros((batch, T), bool)
    starts[:, 0] = rng.rand(batch) < 0.5
    data = {"observation": ((rng.rand(batch, T, *OBS_SHAPE) < 0.04)
                            * mask[..., None, None]).astype(np.float32),
            "action": rng.randint(0, 3, (batch, T)).astype(np.int32),
            "reward": rng.choice([-1.0, 0.0, 1.0], (batch, T)
                                 ).astype(np.float32),
            "discount": mask.copy(), "start_of_episode": starts,
            "mask": mask}
    return ReplaySample(SampleInfo(np.arange(batch) + batch * seed,
                                   rng.rand(batch) * 0.01 + 1e-4), data)


@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.cuda
def test_transformer_learner_on_the_card_matches_the_cpu(cuda_device,
                                                         head_dim):
    """The sequence double-DQN learner on the card (flash forward through
    the kernel, one launch a layer for each of the online and the target
    pass) against the same learner on the CPU, each step from the CPU's
    state on the same batch: the loss and Adam's first moments within 1e-5
    of their largest magnitude per leaf, the second moments (squared
    gradients, so twice the relative error; 1.04e-5 seen at head_dim 16 on
    a leaf whose largest is 9e-8, NVIDIA H100 80GB HBM3) within 2e-5,
    params within 1e-4 (a tenth of one Adam step: a gradient near Adam's
    eps moves its weight by lr g / (|g| + eps)); one sync a step."""
    from repro_torch import tree
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import Catch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.policies import learning

    cfg = TransformerPolicyConfig(num_layers=2, d_model=64, num_heads=4,
                                  num_kv_heads=2, head_dim=head_dim,
                                  d_ff=128, window=8, sequence_length=16,
                                  batch_size=16, target_update_period=3)
    batches = [_policy_sequences(16, 16, i) for i in range(5)]
    spec = make_environment_spec(Catch())
    card, cpu = (learning.make_learner(spec, cfg, iter(batches),
                                       torch.Generator().manual_seed(0),
                                       priority_update_cb=lambda k, p: None,
                                       device=device)
                 for device in (cuda_device, "cpu"))
    for i in range(len(batches)):
        card.state = tree.map(lambda t: t.to(cuda_device), cpu.state)
        torch.cuda.synchronize()
        before = flash_attention.launches
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                card.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert flash_attention.launches - before == 2 * cfg.num_layers
        syncs = [w for w in caught if "synchronizing CUDA" in str(w.message)]
        assert len(syncs) == 1, [str(w.message) for w in syncs]
        cpu.step()
        loss, cpu_loss = card.metrics["loss"], cpu.metrics["loss"]
        assert abs(loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
        for field, tol in (("mu", 1e-5), ("nu", 2e-5)):
            for a, b in zip(tree.leaves(getattr(card.state.opt_state,
                                                field)),
                            tree.leaves(getattr(cpu.state.opt_state,
                                                field))):
                assert a.device.type == "cuda"
                assert float((a.cpu() - b).abs().max()) <= \
                    tol * float(b.abs().max())
        for a, b in zip(tree.leaves(card.state.params),
                        tree.leaves(cpu.state.params)):
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)


# ------------------------------- continuous control, BC and MCTS learners
PARITY_TOL = 1e-5        # losses and moments, of the CPU's largest per leaf
PARITY_DUAL_TOL = 1e-3   # the 0-d MPO duals (see chip_smoke.py phase 18)
PARITY_PARAM_ATOL = 1e-4


def _sync_count(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA" in str(w.message) for w in caught)


def _pendulum_batch(batch, seed):
    from repro_torch.core.types import Transition
    from repro_torch.replay import ReplaySample, SampleInfo
    rng = np.random.RandomState(seed)
    th, thd = rng.uniform(-np.pi, np.pi, (2, batch)), rng.uniform(-8, 8, (2, batch))
    obs = np.stack([np.cos(th), np.sin(th), thd / 8.0], -1).astype(np.float32)
    return ReplaySample(
        SampleInfo(np.arange(batch, dtype=np.int64), np.full(batch, 1e-3)),
        Transition(obs[0], rng.uniform(-1, 1, (batch, 1)).astype(np.float32),
                   (rng.rand(batch) * 3).astype(np.float32),
                   np.full(batch, 0.97, np.float32), obs[1], ()))


def _catch_transitions(batch, seed):
    from repro_torch.core.types import Transition
    from repro_torch.replay import ReplaySample, SampleInfo
    rng = np.random.RandomState(seed)
    obs = np.zeros((2, batch) + OBS_SHAPE, np.float32)
    for k in range(2):
        obs[k, np.arange(batch), rng.randint(0, 9, batch),
            rng.randint(0, 5, batch)] = 1.0
        obs[k, np.arange(batch), 9, rng.randint(0, 5, batch)] = 1.0
    return ReplaySample(
        SampleInfo(np.arange(batch, dtype=np.int64), np.full(batch, 1e-3)),
        Transition(obs[0], rng.randint(0, 3, batch).astype(np.int32),
                   np.zeros(batch, np.float32), np.ones(batch, np.float32),
                   obs[1], ()))


def _mcts_sequences(batch, seed, T=10):
    from repro_torch.replay import ReplaySample, SampleInfo
    rng = np.random.RandomState(seed)
    mask = (np.arange(T)[None] < rng.randint(1, T + 1, batch)[:, None]
            ).astype(np.float32)
    visits = rng.randint(0, 12, (batch, T, 3)).astype(np.float32) + 1e-3
    data = {"observation": ((rng.rand(batch, T, *OBS_SHAPE) < 0.04)
                            * mask[..., None, None]).astype(np.float32),
            "action": rng.randint(0, 3, (batch, T)).astype(np.int32),
            "reward": rng.choice([-1.0, 0.0, 1.0], (batch, T)
                                 ).astype(np.float32),
            "discount": mask.copy(),
            "start_of_episode": np.arange(T)[None].repeat(batch, 0) == 0,
            "search_probs": visits / visits.sum(-1, keepdims=True),
            "mask": mask}
    return ReplaySample(SampleInfo(np.arange(batch), np.ones(batch)), data)


def _shared_normal(generator, shape):
    """The same normal draws for the card's learner and the CPU's (their
    generators differ): made on the CPU from the learner's seed and the
    draw's rank, sent to the card from pinned memory (no sync)."""
    cpu = torch.Generator().manual_seed(generator.initial_seed() * 4
                                        + len(shape))
    x = torch.randn(tuple(shape), generator=cpu)
    if generator.device.type == "cuda":
        return x.pin_memory().to(generator.device, non_blocking=True)
    return x


def _learner_pair(make, batches, cuda_device):
    return tuple(make(iter(batches), device)
                 for device in (cuda_device, "cpu"))


def _assert_card_matches_cpu(card, cpu, batches, duals=()):
    """Each step from the CPU's state on the same batch: one sync; the
    metrics and Adam's moments within PARITY_TOL of the CPU's largest
    magnitude per leaf (``duals``, 0-d leaves, within PARITY_DUAL_TOL),
    params within PARITY_PARAM_ATOL."""
    from repro_torch import tree
    for _ in batches:
        card.state = tree.map(lambda t: t.to("cuda"), cpu.state)
        assert _sync_count(card.step) == 1
        cpu.step()
        for name, value in cpu.metrics.items():
            if name != "learner_walltime":
                assert abs(card.metrics[name] - value) <= \
                    PARITY_TOL * max(abs(value), 1e-30), name
        adams = card.state.opt_state, cpu.state.opt_state
        if not hasattr(adams[0], "mu"):       # (policy Adam, critic Adam)
            adams = adams[0][0], adams[1][0]
        for field in ("mu", "nu"):
            mine, theirs = (getattr(a, field) for a in adams)
            for name in (mine if isinstance(mine, dict) else range(
                    len(mine))):
                tol = PARITY_DUAL_TOL if name in duals else PARITY_TOL
                for a, b in zip(tree.leaves(mine[name]),
                                tree.leaves(theirs[name])):
                    assert a.device.type == "cuda"
                    assert float((a.cpu() - b).abs().max()) <= \
                        tol * float(b.abs().max()), (field, name)
        for a, b in zip(tree.leaves(card.state.params),
                        tree.leaves(cpu.state.params)):
            torch.testing.assert_close(a.cpu(), b, atol=PARITY_PARAM_ATOL,
                                       rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["ddpg", "d4pg", "mpo", "dmpo"])
def test_continuous_learner_on_the_card_matches_the_cpu(cuda_device, algo,
                                                        monkeypatch):
    """A continuous-control learner on the card against its CPU twin, step
    by step from the same state, MPO and DMPO on one shared normal
    stream."""
    from repro_torch.agents import continuous
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import PendulumSwingup
    monkeypatch.setattr(continuous, "learner_normal", _shared_normal)
    cfg = continuous.ContinuousConfig(algo=algo, hidden=64, batch_size=32,
                                      num_atoms=21, vmax=60.0,
                                      mpo_samples=8, target_update_period=2)
    spec = make_environment_spec(PendulumSwingup())
    batches = [_pendulum_batch(32, i) for i in range(3)]
    card, cpu = _learner_pair(
        lambda it, device: continuous.make_learner(
            spec, cfg, it, torch.Generator().manual_seed(0), device=device),
        batches, cuda_device)
    _assert_card_matches_cpu(card, cpu, batches,
                             duals=("log_temp", "log_alpha_mean",
                                    "log_alpha_std"))
    assert int(card.state.opt_state[1].step) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["discrete", "continuous", "mcts"])
def test_bc_and_mcts_learners_on_the_card_match_the_cpu(cuda_device, kind):
    from repro_torch.agents import bc, mcts
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import Catch, PendulumSwingup
    if kind == "mcts":
        spec = make_environment_spec(Catch())
        batches = [_mcts_sequences(8, i) for i in range(3)]

        def make(it, device):
            return mcts.make_learner(spec, mcts.MCTSConfig(batch_size=8), it,
                                     torch.Generator().manual_seed(0),
                                     device=device)
    else:
        continuous = kind == "continuous"
        spec = make_environment_spec(PendulumSwingup() if continuous
                                     else Catch())
        batches = [(_pendulum_batch if continuous else _catch_transitions)(
            32, i) for i in range(3)]

        def make(it, device):
            return bc.make_learner(spec, bc.BCConfig(continuous=continuous),
                                   it, torch.Generator().manual_seed(0),
                                   device=device)
    card, cpu = _learner_pair(make, batches, cuda_device)
    _assert_card_matches_cpu(card, cpu, batches)


@pytest.mark.cuda
def test_mcts_evaluate_on_the_card_gives_the_cpus_priors(cuda_device):
    """The search's network evaluation on the card: the CPU's priors and
    value within 1e-6, and one sync (the priors' copy to the host)."""
    from repro_torch.agents import mcts
    from repro_torch.core import (VariableClient, VariableServer,
                                  make_environment_spec)
    from repro_torch.envs import Catch
    spec = make_environment_spec(Catch())
    cfg = mcts.MCTSConfig()
    init, _, _, _ = mcts.make_network(spec, cfg, device="cpu")
    params = {k: [{n: w.numpy() for n, w in layer.items()} for layer in v]
              for k, v in init(torch.Generator().manual_seed(0)).items()}
    card, cpu = (mcts.MCTSActor(spec, cfg, VariableClient(VariableServer(
        policy=params)), device=device) for device in (cuda_device, "cpu"))
    env = Catch(seed=3)
    ts = env.reset()
    card._evaluate(ts.observation)                 # params to the card
    while not ts.last():
        out = []
        assert _sync_count(lambda: out.append(
            card._evaluate(ts.observation))) == 1
        priors, value = out[0]
        cpu_priors, cpu_value = cpu._evaluate(ts.observation)
        np.testing.assert_allclose(priors, cpu_priors, atol=1e-6, rtol=0)
        assert abs(value - cpu_value) <= 1e-6
        ts = env.step(1)
