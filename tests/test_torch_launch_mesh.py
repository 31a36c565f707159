"""The host mesh and the training driver under it on the CPU:
``make_host_mesh("cpu")`` is a (1, 1) mesh with the JAX package's axis
names over a world-size-1 group and reuses a group that is up;
``make_host_mesh()`` asks for the card and raises without one; and
``train.main`` under the host mesh and its rules prints the same metrics,
bit for bit, as the same run without them (the layout hints do nothing on
plain tensors).  Every test leaves no process group behind."""
import argparse

import pytest
import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def no_group_after():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_host_mesh_on_the_cpu():
    mesh = mesh_lib.make_host_mesh("cpu")
    assert mesh.device_type == "cpu"
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert dist.get_world_size() == 1
    again = mesh_lib.make_host_mesh("cpu")          # the group is reused
    assert tuple(again.shape) == (1, 1) and dist.get_world_size() == 1
    rules = sharding.ShardingRules(mesh)
    assert rules._axis_sizes == {"data": 1, "model": 1}
    assert rules.mesh_axes(("batch", "vocab"), (8, 512)) == ("data",
                                                             "model")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_host_mesh_asks_for_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.make_host_mesh()
    assert not dist.is_initialized()


def test_hardware_constants_are_the_h100s_datasheet_figures():
    assert mesh_lib.PEAK_FLOPS_BF16 == 989e12
    assert mesh_lib.HBM_BW == 3.35e12
    assert mesh_lib.HBM_PER_CHIP == 80 * 10 ** 9
    assert mesh_lib.IB_BW == 50e9


ARGV = ["--arch", "qwen3-1.7b", "--device", "cpu", "--steps", "20",
        "--batch", "4", "--seq", "32"]


def test_main_under_the_host_mesh_prints_the_run_without_it(capsys):
    """``main`` builds the host mesh and runs under its rules; the same
    arguments through the run without them print the same CE at every
    report, and the group ``main`` started is gone after it."""
    assert train.main(ARGV) == 0
    under_mesh = capsys.readouterr().out
    assert not dist.is_initialized()

    parser = argparse.Namespace(arch="qwen3-1.7b", steps=20, batch=4, seq=32,
                                lr=3e-4, objective="bc",
                                checkpoint_dir=None, full_size=False,
                                device="cpu")
    assert sharding.current_rules() is None
    assert train._train(reduced(get_arch("qwen3-1.7b")), parser) == 0
    plain = capsys.readouterr().out

    def metrics(text):
        return [line.split("(")[0] for line in text.splitlines()
                if line.startswith(("step", "done"))]

    assert metrics(under_mesh) == metrics(plain)
    assert "step   20  ce" in under_mesh


def test_main_keeps_a_group_that_was_up():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    assert train.main(ARGV[:-4] + ["--steps", "2", "--batch", "2",
                                   "--seq", "8"]) in (0, 1)
    assert dist.is_initialized()


@pytest.mark.parametrize("multi_pod,shape,names", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model")),
])
def test_production_mesh_over_a_fake_group(multi_pod, shape, names):
    """The JAX package's production shapes and axis names, on the CPU, over
    the fake group of 256 or 512 ranks that the dry run starts."""
    from repro_torch.launch import dryrun

    with dryrun.fake_process_group(256 * (2 if multi_pod else 1)):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        assert mesh.device_type == "cpu"
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == names
