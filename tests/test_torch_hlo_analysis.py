"""The port's ``hlo_analysis``: the JAX package's ``Analysis`` record, and
``LocalCounter``, which fills it from an eager run of one rank's local ops
(the port produces no HLO, so the JAX package's HLO text parser has no
counterpart).  Tensors are fake: nothing is allocated."""
import pytest
import torch

from repro.launch import hlo_analysis as jax_H
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.specs import fake_mode


def test_analysis_is_the_references_record():
    got, want = H.Analysis(), jax_H.Analysis()
    assert got.as_dict() == want.as_dict()
    for a in (got, want):
        a.flops, a.hbm_bytes, a.collective_bytes = 6.0, 10.0, 4.0
        a.collectives["all-reduce"]["count"] += 1
        a.collectives["all-reduce"]["bytes"] += 4.0
    assert got.as_dict() == want.as_dict()
    assert H.COLLECTIVE_KINDS == jax_H.COLLECTIVE_KINDS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counter_counts_a_products_flops_and_bytes(dtype):
    """(8, 16) @ (16, 32): 2*M*N*K FLOPs, all of them dot FLOPs, and the
    operands' and output's bytes as the eager op's traffic."""
    with fake_mode():
        a, b = torch.empty(8, 16, dtype=dtype), torch.empty(16, 32,
                                                            dtype=dtype)
    counter = H.LocalCounter()
    with counter:
        a @ b
    an, size = counter.analysis, dtype.itemsize
    assert an.flops == an.dot_flops == 2 * 8 * 16 * 32
    assert an.conv_flops == 0 and an.collective_bytes == 0
    assert an.hbm_bytes == (8 * 16 + 16 * 32 + 8 * 32) * size
    assert counter.ops == 1


def test_counter_counts_no_bytes_for_a_view():
    with fake_mode():
        x = torch.empty(4, 6)
    counter = H.LocalCounter()
    with counter:
        x.view(6, 4).t()
    assert counter.analysis.hbm_bytes == 0 and counter.analysis.flops == 0


def test_counter_peak_follows_live_storages():
    """Tracked arguments count from the start; a temporary that dies
    leaves the peak where it was and the live bytes fall back."""
    with fake_mode():
        x = torch.empty(1024)
    counter = H.LocalCounter()
    with counter:
        counter.track([x])
        assert counter.live_bytes == 4096
        y = x * 2
        assert counter.peak_bytes == 8192
        del y
        assert counter.live_bytes == 4096
        z = x + 1
    assert counter.peak_bytes == 8192 and z.shape == x.shape


def test_counter_puts_dtensors_private_parts_back_on_exit():
    """The three private DTensor functions the counter adjusts are the
    originals again once it exits, also when the block raises."""
    from torch.distributed.tensor import _sharding_prop

    prop = _sharding_prop.ShardingPropagator
    original = prop.__dict__["_propagate_tensor_meta_non_cached"]
    counter = H.LocalCounter()
    with pytest.raises(ValueError):
        with counter:
            assert prop.__dict__["_propagate_tensor_meta_non_cached"] \
                is not original
            raise ValueError
    assert prop.__dict__["_propagate_tensor_meta_non_cached"] is original
