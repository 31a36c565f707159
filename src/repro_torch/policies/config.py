"""Configuration for the transformer policy subsystem (a copy of
``repro.policies.config``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TransformerPolicyConfig:
    """Knobs for ``TransformerPolicyBuilder``.

    Architecture: a small dense transformer over a sliding window of the
    last ``window`` observations, each projected to a ``d_model`` token.
    Serving: ``cache_slots`` bounds concurrent episodes holding a KV-cache
    slot on the inference server; ``backend`` picks the decode-attention
    path (``"auto"`` = the CUDA ``decode_attention`` kernel for CUDA
    tensors, its plain version in ``kernels/ref.py`` for CPU tensors;
    ``"kernel"``/``"ref"``/``"grouped"`` force one).  Learning (the
    training slice): R2D2-style sequence double-DQN over replayed windows.
    """

    # architecture
    num_layers: int = 2
    d_model: int = 64
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 32
    d_ff: int = 128
    window: int = 8                  # observations the policy attends over

    # acting / serving
    epsilon: float = 0.1
    cache_slots: int = 64            # concurrent episodes on the server
    slot_timeout_s: float = 5.0      # acquire() backpressure bound
    backend: str = "auto"            # decode-attention path

    # learning (sequence double-DQN, R2D2-style schedule)
    learning_rate: float = 1e-3
    discount: float = 0.99
    sequence_length: int = 16
    period: int = 8                  # overlapping sequences
    batch_size: int = 16
    target_update_period: int = 100
    min_replay_size: int = 100
    max_replay_size: int = 20_000
    samples_per_insert: float = 4.0
    priority_eta: float = 0.9        # max/mean TD mixing
    importance_beta: float = 0.6
