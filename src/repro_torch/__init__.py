"""repro_torch — the PyTorch and CUDA port of ``repro`` for an NVIDIA H100.

A second package beside the JAX reference ``repro``: it mirrors its module
paths and names, imports ``torch`` and never ``jax`` or ``repro``, and
replaces each Pallas TPU kernel on a ported path with a kernel written by
hand for Hopper (``repro_torch.kernels``).  Entry points take ``device=``
and default to ``"cuda"``; the CPU is used only when a caller asks for it.

Ported so far: transformer-policy serving on Catch — specs, Catch, the
environment loop, the variable client, the telemetry registry, the dense
transformer stack, the KV-cache pool, the policy engine, the windowed actors
and the batching inference server, with decode attention as a CUDA kernel;
and the IMPALA learner on Catch — vectorized envs and acting, replay and
adders, the functional optimizers, the agent and its builder, with V-trace
as a CUDA kernel.  ``repro_torch.tree`` walks trees in JAX's leaf order.
"""
