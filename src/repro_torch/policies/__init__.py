"""Transformer policies on the serving fast path, and their training.

A sliding window of observations is the policy's token sequence, acting
runs incremental KV-cache decode (on the CUDA ``decode_attention`` kernel on
the card), and one continuous-batching ``TransformerInferenceServer`` with
per-episode cache slots serves every actor.  ``TransformerPolicyBuilder``
trains the policy with sequence double-DQN over replayed windows (on the
CUDA flash-attention kernel on the card).
"""
from repro_torch.policies.builder import (TransformerPolicy,
                                          TransformerPolicyBuilder)
from repro_torch.policies.cache import CacheSlotsExhausted, KVCachePool
from repro_torch.policies.config import TransformerPolicyConfig
from repro_torch.policies.engine import PolicyEngine
from repro_torch.policies.serving import TransformerInferenceServer

__all__ = [
    "CacheSlotsExhausted",
    "KVCachePool",
    "PolicyEngine",
    "TransformerInferenceServer",
    "TransformerPolicy",
    "TransformerPolicyBuilder",
    "TransformerPolicyConfig",
]
