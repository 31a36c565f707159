"""repro_torch on a card: the CUDA decode-attention and V-trace kernels
against their plain versions, their argument checks and launch counts, the
kernel-backed engine against the plain one, the serving path's launch count,
and an IMPALA learner step that launches V-trace once and syncs once.

Every test here is marked ``cuda`` and skips without a CUDA device; this
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import HEAD_DIMS, decode_attention
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
VTRACE_TOL = 1e-4      # f32; the kernel contracts to FMAs, the plain version not
VTRACE_SHAPES = [(20, 16), (16, 128), (64, 256), (100, 128), (20, 37), (1, 5),
                 (100, 16384)]


def _vtrace_inputs(T, B, device, seed=0):
    """rhos below and above the clips, discounts with zeros (episode ends)."""
    rng = np.random.RandomState(seed)
    discounts = rng.rand(T, B) * 0.99
    discounts[rng.rand(T, B) < 0.1] = 0.0
    arrays = (rng.randn(T, B), rng.randn(T, B), rng.randn(T, B), discounts,
              np.abs(rng.randn(T, B)) + 0.1)
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
    with pytest.raises(ValueError, match="contiguous"):
        vtrace(*(t.t().contiguous().t() for t in tensors))
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
