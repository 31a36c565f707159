"""The port's dry run against the JAX package: ``model_flops_analytic`` for
every combo, the per-rank counter (a product sharded 8 ways counts 1/8 of
its FLOPs), the counter's dot FLOPs on three reduced prefills against the
JAX package's ``hlo_analysis`` of the same compiled step, and ``run_combo``
reaching ``ok`` for a reduced combo of each kind on a fake 4x2 mesh (each
run initialises its fake process group and destroys it before it
returns)."""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro import configs as jax_configs
from repro.launch import dryrun as jax_dryrun
from repro.launch import hlo_analysis as jax_H
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tf
from repro_torch import configs
from repro_torch.launch import dryrun, hlo_analysis, steps
from repro_torch.launch.specs import params_specs, sds
from repro_torch.models.config import InputShape

MESH_4X2 = ((4, 2), ("data", "model"))
# the JAX package's hlo_analysis dot_flops of jax.jit(make_prefill_step(
# reduced(cfg))) at batch 2, seq 256, float32, compiled on one CPU device
REFERENCE_PREFILL_DOT_FLOPS = {
    "qwen3-1.7b": 1_275_592_704,
    "granite-moe-3b-a800m": 892_485_632,
    "zamba2-1.2b": 2_182_610_944,
}


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_model_flops_analytic_equals_the_references(arch):
    for shape in configs.INPUT_SHAPES:
        assert dryrun.model_flops_analytic(
            configs.get_arch(arch), configs.get_shape(shape)) == \
            jax_dryrun.model_flops_analytic(jax_configs.get_arch(arch),
                                            jax_configs.get_shape(shape))


def test_tables_are_the_references():
    assert dryrun.SKIPS == jax_dryrun.SKIPS
    assert dryrun.COMBO_OVERRIDES == jax_dryrun.COMBO_OVERRIDES
    assert dryrun.SLIDING_WINDOW_FOR_LONG == \
        jax_dryrun.SLIDING_WINDOW_FOR_LONG


def test_a_product_sharded_8_ways_counts_an_eighth_of_its_flops():
    """(256, 64, 1024) @ (1024, 4096) with the batch on ``data`` (4) and N
    on ``model`` (2) counts 1/8 of 2*M*N*K on rank 0, and all of it when
    both operands are replicated; nothing is allocated."""
    from torch.distributed.tensor import Replicate, Shard

    global_flops = 2 * 256 * 64 * 1024 * 4096
    with dryrun.fake_process_group(8):
        mesh = dryrun._make_mesh(MESH_4X2)
        with dryrun.fake_mode():
            x, w = torch.empty(256, 64, 1024), torch.empty(1024, 4096)
        for placements, share in (
                (([Shard(0), Replicate()], [Replicate(), Shard(1)]), 8),
                (([Replicate(), Replicate()], [Replicate(), Replicate()]),
                 1)):
            xd, wd = (dryrun.distribute(t, p, mesh)
                      for t, p in zip((x, w), placements))
            counter = hlo_analysis.LocalCounter()
            with counter:
                counter.track([xd, wd])
                y = xd @ wd
            assert counter.analysis.dot_flops == global_flops / share
            assert counter.analysis.collective_bytes == 0
            assert y._local_tensor.numel() == 256 * 64 * 4096 // share
            # operands and output, rank 0's shards, all live at the end
            assert counter.peak_bytes == sum(
                4 * t._local_tensor.numel() for t in (xd, wd, y))
    assert not dist.is_initialized()


def _reference_prefill_dot_flops(arch):
    jcfg = jax_configs.reduced(jax_configs.get_arch(arch))
    params = jax_tf.init(jax.random.key(0), jcfg, jnp.float32)
    batch = {"tokens": jnp.zeros((2, 256), jnp.int32)}
    compiled = jax.jit(jax_steps.make_prefill_step(jcfg)).lower(
        params, batch).compile()
    return jax_H.analyze(compiled.as_text()).dot_flops


@pytest.mark.parametrize("arch", sorted(REFERENCE_PREFILL_DOT_FLOPS))
def test_prefill_dot_flops_match_the_references_compiled_count(arch):
    """One rank, no mesh: the counter's dot FLOPs of the port's reduced
    prefill (batch 2, seq 256, float32) against the JAX package's HLO
    count of the compiled step, within 1% (they are equal: the SSM's chunked
    scan counts the same products)."""
    cfg = configs.reduced(configs.get_arch(arch))
    counter = hlo_analysis.LocalCounter()
    params = params_specs(cfg, torch.float32)
    with counter:
        steps.make_prefill_step(cfg)(params,
                                     {"tokens": sds((2, 256), torch.int32)})
    want = _reference_prefill_dot_flops(arch)
    assert want == REFERENCE_PREFILL_DOT_FLOPS[arch]
    assert abs(counter.analysis.dot_flops / want - 1) < 0.01
    assert counter.analysis.collective_bytes == 0


KINDS = {
    "prefill": ("qwen3-1.7b", InputShape("prefill_32k", 64, 8, "prefill")),
    "decode": ("whisper-base", InputShape("decode_32k", 64, 8, "decode")),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_run_combo_reaches_ok_on_a_fake_4x2_mesh(kind):
    arch, shape = KINDS[kind]
    cfg = configs.reduced(configs.get_arch(arch))
    rec = dryrun.run_combo(arch, shape.name, MESH_4X2, cfg=cfg, shape=shape)
    assert rec["status"] == "ok", rec.get("error")
    check_record(rec, cfg, shape)


def check_record(rec, cfg, shape):
    """The reference's record keys and its dry-run test's assertions."""
    assert not dist.is_initialized()
    assert rec["chips"] == 8 and rec["mesh"] == "4x2"
    assert rec["route"] == "plain" and rec["trace_s"] > 0
    assert rec["params"] == cfg.num_params()
    assert rec["memory"]["fits_hbm"] and rec["memory"]["approx_live_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["hlo"]["flops"] > 0 and rec["hlo"]["hbm_bytes"] > 0
    assert set(rec["hlo"]["collectives"]) <= set(hlo_analysis.COLLECTIVE_KINDS)
    assert rec["roofline"]["model_flops_per_chip"] == \
        dryrun.model_flops_analytic(cfg, shape) / 8
    assert not [r for r in rec["dtensor_rules"] if r.startswith("replicated")]


def test_a_combo_in_a_process_with_a_group_up_is_an_error_record():
    """The dry run needs its own fake group: with another one up the
    record says so, and the group that was up stays up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        arch, shape = KINDS["decode"]
        rec = dryrun.run_combo(arch, shape.name, MESH_4X2,
                               cfg=configs.reduced(configs.get_arch(arch)),
                               shape=shape)
        assert rec["status"] == "error" and "already" in rec["error"]
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_skips_and_long_context_variants_as_the_reference():
    rec = dryrun.run_combo("whisper-base", "long_500k", "single")
    assert rec["status"] == "skipped" and "reason" in rec
    assert not dist.is_initialized()


def test_sliding_window_variant_reaches_ok_on_a_fake_4x2_mesh():
    """long_500k's dense variant (a sliding window) decodes through the
    ring cache on the 4x2 mesh."""
    cfg = configs.reduced(configs.get_arch("qwen3-1.7b"))
    shape = InputShape("long_500k", 96, 8, "decode")
    rec = dryrun.run_combo("qwen3-1.7b", "long_500k", MESH_4X2, cfg=cfg,
                           shape=shape)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["variant"] == "sliding_window=8192"
