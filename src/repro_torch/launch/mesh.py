"""Mesh definitions over ``torch.distributed`` and the card's constants.

``make_production_mesh`` is a FUNCTION so importing this module never touches
process-group state.  Single pod: 16x16 = 256 ranks, axes (data, model).
Multi-pod: 2x16x16 = 512 ranks, axes (pod, data, model) — the leading ``pod``
axis is pure data parallelism across pods, matching how Acme's learner
would be replicated per pod with gradient all-reduce across pods.  It builds
the mesh over the process group that is already initialised: the dry run
initialises a fake one of 256 or 512 ranks (``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the initialised process group, whose world
    size must be 512 (``multi_pod``) or 256.  It exists for the dry run,
    whose fake group has no card behind it: the mesh's device type is
    ``"cpu"``, the device of the fake tensors it traces."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(device="cuda"):
    """1-rank ``(1, 1)`` mesh (axes data, model, each of size 1) on
    ``device``.  It starts a world-size-1 process group over an in-memory
    store, which opens no network port, or reuses the group already up;
    raises ``RuntimeError`` for a CUDA device when there is no card."""
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: no CUDA device")
        torch.cuda.set_device(device.index or 0)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return DeviceMesh(device.type, torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))


# NVIDIA H100 80GB HBM3 (SXM5), 700 W: datasheet figures for the roofline
# analysis, not measurements of the card.  The names are the JAX
# package's, but for the collective bandwidth: its ``ICI_BW`` (the TPU's
# inter-chip link) is ``IB_BW`` here, the link a model-axis collective
# crosses on H100 nodes, and the dry run divides collective bytes by it.
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s (NVIDIA
                                  # H100 datasheet, SXM5; 1979e12 is sparse)
HBM_BW = 3.35e12                  # bytes/s of HBM3 (NVIDIA H100 datasheet)
# A 16-wide model axis spans two 8-GPU NVLink nodes, so its collectives
# cross InfiniBand: one 400 Gb/s NDR port a GPU (NVIDIA DGX H100
# datasheet), 50e9 bytes/s.  Inside a node NVLink 4 gives 450e9 bytes/s
# each way (900 GB/s both ways, NVIDIA H100 datasheet), which no
# production axis stays within.
IB_BW = 50e9
HBM_PER_CHIP = 80 * 10 ** 9       # the card's 80 GB (NVIDIA H100 datasheet)
