"""The transformer Q-network: observations in, Q-values out.

Three views of ONE parameter set, all running the same
``repro_torch.models.transformer`` dense stack:

- ``q_sequence``: full-sequence recompute over (B, T) observation windows —
  the parity oracle for the decode paths.
- ``q_prefill``: batched prompt prefill THROUGH the KV cache (one call for
  a whole window, right-padded rows masked via ``lengths``).
- ``q_decode``: one-token incremental decode against the cache with
  per-row positions — the serving hot path, on the CUDA
  ``decode_attention`` kernel by default on the card.

Observations are embedded by a learned linear projection (``obs_proj``)
instead of a token table, and Q-values come from a linear ``head`` instead
of the unembedding.  ``sliding_window = window`` makes full-sequence
attention banded, so a learner over length-T sequences and the actor over
length-W windows compute the SAME function (RoPE is relative, so
window-local positions are equivalent to absolute ones).

Parameters are a dict with the JAX package's leaf names and layouts:
``obs_proj.{w (obs_dim, d), b}``, ``blocks`` (one dict per layer:
``ln1.scale``, ``attn.{wq (d, h, hd), wk, wv, wo (h, hd, d)}``,
``ln2.scale``, ``mlp.{w_gate, w_up, w_down}``), ``final_norm.scale`` and
``head (d, A)``.  ``params_from_jax`` carries a JAX tree across.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers, transformer
from repro_torch.models.config import ArchConfig

_BLOCK_LEAVES = {"ln1": ("scale",), "attn": ("wq", "wk", "wv", "wo"),
                 "ln2": ("scale",), "mlp": ("w_gate", "w_up", "w_down")}


def make_arch(cfg, num_actions: int) -> ArchConfig:
    """The ``ArchConfig`` for a policy; ``cfg`` is a TransformerPolicyConfig."""
    return ArchConfig(
        name="transformer_policy", arch_type="dense",
        num_layers=cfg.num_layers, d_model=cfg.d_model,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        d_ff=cfg.d_ff, vocab_size=max(num_actions, 1),
        head_dim=cfg.head_dim, rope_theta=10_000.0,
        sliding_window=cfg.window, tie_embeddings=True,
        source="repro_torch.policies")


def init(generator, arch: ArchConfig, obs_dim: int, num_actions: int,
         device="cuda", dtype=torch.float32):
    """Fresh parameters with the reference's shapes and init scales, drawn
    from ``generator`` (a CPU ``torch.Generator``)."""
    return {
        "obs_proj": {
            "w": layers.dense_init(generator, obs_dim, arch.d_model, device,
                                   dtype),
            "b": torch.zeros((arch.d_model,), device=device, dtype=dtype),
        },
        "blocks": transformer.init_blocks(generator, arch, device, dtype),
        "final_norm": layers.rmsnorm_init(arch.d_model, device, dtype),
        "head": layers.dense_init(generator, arch.d_model, num_actions,
                                  device, dtype),
    }


def params_from_jax(tree, device="cuda"):
    """The port's parameters from the reference's ``network.init`` tree,
    every leaf a numpy array: a name-for-name copy, with the stacked
    per-layer leaves of ``blocks`` split along their leading layer axis."""
    def tensor(x):
        return torch.tensor(np.asarray(x), device=device)

    blocks = tree["blocks"]
    num_layers = blocks["ln1"]["scale"].shape[0]
    return {
        "obs_proj": {"w": tensor(tree["obs_proj"]["w"]),
                     "b": tensor(tree["obs_proj"]["b"])},
        "blocks": [{group: {leaf: tensor(blocks[group][leaf][i])
                            for leaf in leaves}
                    for group, leaves in _BLOCK_LEAVES.items()}
                   for i in range(num_layers)],
        "final_norm": {"scale": tensor(tree["final_norm"]["scale"])},
        "head": tensor(tree["head"]),
    }


def embed_obs(params, obs):
    """(..., obs_dim) float32 -> (..., d_model)."""
    p = params["obs_proj"]
    return torch.einsum("...i,id->...d", obs, p["w"]) + p["b"]


def _q_head(params, feats):
    return torch.einsum("...d,da->...a", feats, params["head"])


def q_sequence(params, arch: ArchConfig, obs):
    """Full-sequence Q-values: obs (B, T, obs_dim) -> (B, T, A)."""
    feats = transformer.forward_embedded(params, arch, embed_obs(params, obs))
    return _q_head(params, feats)


def init_cache(arch: ArchConfig, batch: int, device="cuda"):
    """Decode caches sized to the policy window (the ring length)."""
    return transformer.init_cache(arch, batch, arch.sliding_window,
                                  torch.float32, device)


def q_prefill(params, arch: ArchConfig, cache, obs, lengths):
    """Batched window prefill through the cache.

    obs (b, W, obs_dim) LEFT-aligned, zero-padded on the right; lengths (b,)
    real window lengths.  Returns ((b, W, A), cache) — decode continues
    at per-row position ``lengths[i]``.  On the card the window's attention
    runs in flash attention (``attention.prefill_attention``).
    """
    feats, cache = transformer.prefill_embedded(
        params, arch, cache, embed_obs(params, obs), lengths=lengths)
    return _q_head(params, feats), cache


def q_decode(params, arch: ArchConfig, cache, obs, pos, *,
             backend: str = "grouped"):
    """One-observation incremental decode: obs (b, obs_dim), pos (b,)
    cache positions.  Returns ((b, A), cache)."""
    x = embed_obs(params, obs)[:, None, :]
    feats, cache = transformer.decode_step_embedded(
        params, arch, cache, x, pos, backend=backend)
    return _q_head(params, feats), cache
