"""The dense transformer stack over pre-embedded inputs.

Plain functions over a dict of tensors.  The JAX package stacks per-layer
parameters along a leading ``layers`` axis and scans over it; here
``params["blocks"]`` is a LIST of per-layer dicts (same leaf names, no
layer axis) and the layers run in a Python loop.  The decode cache keeps the
reference's stacked layout, ``{"kv": {"k", "v"}}`` with leaves
``(layers, batch, length, kv_heads, head_dim)``, and each layer updates its
row of it in place.

Public API (dense family only; MoE, SSM, hybrid, VLM and Whisper come with
the model-zoo slice):
  forward_embedded(params, cfg, x)                 -> features
  init_cache(cfg, batch, max_len, dtype, device)   -> decode cache
  prefill_embedded(params, cfg, cache, x, lengths) -> (features, cache)
  decode_step_embedded(params, cfg, cache, x, pos) -> (features, cache)

``params`` here holds ``"blocks"`` and ``"final_norm"``;
``repro_torch.policies.network`` adds the observation projection and the
Q head around it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]


def _check_dense(cfg: ArchConfig, what: str):
    if cfg.arch_type != "dense":
        raise ValueError(f"{what} supports dense archs, got {cfg.arch_type}")


# ======================================================================
# Init
# ======================================================================
def _dense_block_init(generator, cfg: ArchConfig, device="cuda",
                      dtype=torch.float32):
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, device, dtype),
        "attn": attn.attn_init(generator, cfg, device, dtype),
        "ln2": layers.rmsnorm_init(cfg.d_model, device, dtype),
        "mlp": layers.mlp_init(generator, cfg.d_model, cfg.d_ff, device,
                               dtype),
    }


def init_blocks(generator, cfg: ArchConfig, device="cuda",
                dtype=torch.float32):
    """One parameter dict per layer."""
    _check_dense(cfg, "init_blocks")
    return [_dense_block_init(generator, cfg, device, dtype)
            for _ in range(cfg.num_layers)]


# ======================================================================
# Forward (train / prefill)
# ======================================================================
def _dense_block(bp, cfg: ArchConfig, x, positions):
    x = x + attn.attention(bp["attn"], cfg,
                           layers.rmsnorm(bp["ln1"], x, cfg.rmsnorm_eps),
                           positions)
    y = layers.rmsnorm(bp["ln2"], x, cfg.rmsnorm_eps)
    return x + layers.mlp(bp["mlp"], y)


def forward_embedded(params: Params, cfg: ArchConfig, x, *, positions=None):
    """Dense-stack forward over PRE-EMBEDDED inputs.

    x: (b, s, d_model) — e.g. projected observations rather than token
    embeddings.  Runs ``params["blocks"]`` + final norm and returns the
    features (b, s, d_model); the dense stack has no auxiliary losses.
    """
    _check_dense(cfg, "forward_embedded")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    for bp in params["blocks"]:
        x = _dense_block(bp, cfg, x, positions)
    return layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)


# ======================================================================
# Decode
# ======================================================================
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Stacked per-layer decode caches: ``{"kv": {"k", "v"}}`` with leaves
    (layers, batch, length, kv_heads, head_dim)."""
    _check_dense(cfg, "init_cache")
    one = attn.init_kv_cache(cfg, batch, max_len, dtype, device)
    return {"kv": {name: torch.zeros((cfg.num_layers,) + t.shape, dtype=dtype,
                                     device=device)
                   for name, t in one.items()}}


def _layer_cache(cache, i: int):
    return {name: t[i] for name, t in cache["kv"].items()}


def _decode_dense_block(bp, cfg, x, kv_cache, pos, backend="grouped"):
    h, kv_cache = attn.decode_attention(
        bp["attn"], cfg, layers.rmsnorm(bp["ln1"], x, cfg.rmsnorm_eps),
        kv_cache, pos, backend=backend)
    x = x + h
    y = layers.rmsnorm(bp["ln2"], x, cfg.rmsnorm_eps)
    return x + layers.mlp(bp["mlp"], y), kv_cache


def _prefill_dense_block(bp, cfg, x, kv_cache, positions, lengths=None):
    """``_decode_dense_block``'s batched-prompt twin: the whole prompt's K/V
    lands in the cache in one attention call, not one call per token."""
    h, kv_cache = attn.prefill_attention(
        bp["attn"], cfg, layers.rmsnorm(bp["ln1"], x, cfg.rmsnorm_eps),
        kv_cache, positions, lengths=lengths)
    x = x + h
    y = layers.rmsnorm(bp["ln2"], x, cfg.rmsnorm_eps)
    return x + layers.mlp(bp["mlp"], y), kv_cache


def prefill_embedded(params: Params, cfg: ArchConfig, cache, x, *,
                     lengths=None):
    """Batched prompt prefill over PRE-EMBEDDED inputs.

    x: (b, s, d_model) with s <= cache length; rows shorter than ``s`` are
    right-padded and masked out via ``lengths`` (b,) int.  The whole
    prompt's K/V lands in the cache (in place) in ONE call per layer, so
    decode can continue at position ``lengths[i]`` without per-token replay.

    Returns (features (b, s, d_model), cache).
    """
    _check_dense(cfg, "prefill_embedded")
    positions = torch.arange(x.shape[1], device=x.device)
    for i, bp in enumerate(params["blocks"]):
        x, _ = _prefill_dense_block(bp, cfg, x, _layer_cache(cache, i),
                                    positions, lengths=lengths)
    return layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps), cache


def decode_step_embedded(params: Params, cfg: ArchConfig, cache, x, pos, *,
                         backend: str = "grouped"):
    """Incremental decode over PRE-EMBEDDED inputs.

    x: (b, 1, d_model); pos: scalar or per-row (b,) positions (continuous
    batching — each row advances independently).  Updates the cache in
    place.  Returns (features (b, d_model), cache).
    """
    _check_dense(cfg, "decode_step_embedded")
    for i, bp in enumerate(params["blocks"]):
        x, _ = _decode_dense_block(bp, cfg, x, _layer_cache(cache, i), pos,
                                   backend=backend)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    return x[:, 0], cache
