"""repro_torch on a card: the CUDA decode-attention kernel against its plain
version, its argument checks, the kernel-backed engine against the plain
one, and the serving path's launch count.

Every test here is marked ``cuda`` and skips without a CUDA device; this
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import HEAD_DIMS, decode_attention
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
