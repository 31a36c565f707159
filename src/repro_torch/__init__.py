"""repro_torch — the PyTorch and CUDA port of ``repro`` for an NVIDIA H100.

A second package beside the JAX reference ``repro``: it mirrors its module
paths and names, imports ``torch`` and never ``jax`` or ``repro``, and
replaces each Pallas TPU kernel on a ported path with a kernel written by
hand for Hopper (``repro_torch.kernels``).  Entry points take ``device=``
and default to ``"cuda"``; the CPU is used only when a caller asks for it.

Ported so far (``ROADMAP.md`` lists the modules): transformer-policy
serving with decode attention as a CUDA kernel; the IMPALA learner with
V-trace as one; batched scoring of Zamba2 with flash attention and the
SSD scan; the DQN experiment loop; the sequence learners; the remaining
agents; distributed execution — courier, program graph, launchers,
sharded replay, learner replicas and the inference servers; fault
tolerance; the model zoo's forward pass, serving and training; and the
launch layer — logical-axis sharding over a torch ``DeviceMesh``
(``repro_torch.sharding``), the meshes, parameter sharding, input specs,
the HLO analysis and the dry run over fake tensors and ``DTensor``s
(``repro_torch.launch``).  ``repro_torch.tree`` walks trees in JAX's leaf
order.
"""
from repro_torch import sharding  # noqa: F401
