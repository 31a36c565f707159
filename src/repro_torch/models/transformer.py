"""Unified model zoo, ported a family at a time: the dense stack over
pre-embedded inputs, and the attention-free Mamba2 (``ssm``) and Zamba2
(``hybrid``) token models.

Plain functions over a dict of tensors.  The JAX package stacks per-layer
parameters along a leading ``layers`` axis and scans over it; here
``params["blocks"]`` is a LIST of per-layer dicts (same leaf names, no
layer axis) and the layers run in a Python loop.  A hybrid model's blocks
are a list of groups, each a list of ``hybrid_attn_every`` Mamba2 layers,
followed by ``tail_blocks`` and one ``shared_attn`` block applied after
every group.  The decode cache keeps the reference's stacked layout,
``{"kv": {"k", "v"}}`` with leaves ``(layers, batch, length, kv_heads,
head_dim)``, and each layer updates its row of it in place.

Public API:
  init(generator, cfg, device, dtype)              -> params (ssm, hybrid)
  params_from_jax(cfg, tree, device)               -> params (ssm, hybrid)
  forward_features(params, cfg, batch)             -> (features, aux)
  unembed_table(params, cfg), mask_pad_logits(logits, cfg)
  forward_embedded(params, cfg, x)                 -> features (dense)
  init_cache(cfg, batch, max_len, dtype, device)   -> decode cache (dense)
  prefill_embedded(params, cfg, cache, x, lengths) -> (features, cache)
  decode_step_embedded(params, cfg, cache, x, pos) -> (features, cache)

The ``*_embedded`` entry points' ``params`` hold ``"blocks"`` and
``"final_norm"``; ``repro_torch.policies.network`` adds the observation
projection and the Q head around them.  MoE, VLM and Whisper, token
decoding of SSM and hybrid models, and ``remat`` (a forward-only port has
nothing to rematerialize) come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]


def _check_dense(cfg: ArchConfig, what: str):
    if cfg.arch_type != "dense":
        raise ValueError(f"{what} supports dense archs, got {cfg.arch_type}")


def _check_token_model(cfg: ArchConfig, what: str):
    if cfg.arch_type not in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{what}: arch_type {cfg.arch_type!r} is not ported yet; the "
            "port runs the ssm and hybrid token models, and the other "
            "families come with the model-zoo slice (ROADMAP slice 8)")


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


def _ssm_block_init(generator, cfg: ArchConfig, device="cuda",
                    dtype=torch.float32):
    return {
        "ln": layers.rmsnorm_init(cfg.d_model, device, dtype),
        "ssm": ssm_lib.ssm_init(generator, cfg, device, dtype),
    }


def init(generator, cfg: ArchConfig, device="cuda", dtype=torch.float32
         ) -> Params:
    """Random params of an ``ssm`` or ``hybrid`` token model, drawn from a
    CPU ``torch.Generator`` and moved to ``device`` a tensor at a time."""
    _check_token_model(cfg, "init")
    pv = cfg.padded_vocab_size
    params: Params = {
        "embed": layers.embed_init(generator, pv, cfg.d_model, device, dtype),
        "final_norm": layers.rmsnorm_init(cfg.d_model, device, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.embed_init(generator, pv, cfg.d_model,
                                              device, dtype)

    def ssm_blocks(count):
        return [_ssm_block_init(generator, cfg, device, dtype)
                for _ in range(count)]

    if cfg.arch_type == "ssm":
        params["blocks"] = ssm_blocks(cfg.num_layers)
    else:
        every = cfg.hybrid_attn_every
        n_groups, rem = divmod(cfg.num_layers, every)
        params["blocks"] = [ssm_blocks(every) for _ in range(n_groups)]
        if rem:
            params["tail_blocks"] = ssm_blocks(rem)
        # one weight set, applied after every group
        params["shared_attn"] = _dense_block_init(generator, cfg, device,
                                                  dtype)
    return params


def params_from_jax(cfg: ArchConfig, tree, device="cuda") -> Params:
    """The JAX package's ``transformer.init`` tree (numpy leaves) in the
    port's layout: ``blocks`` unstacked into per-layer dicts (a list of
    groups of them for ``hybrid``), ``tail_blocks`` into a list, and
    ``shared_attn``, ``embed``, ``lm_head`` and ``final_norm`` copied name
    for name."""
    _check_token_model(cfg, "params_from_jax")

    def copy(node, index=()):
        if isinstance(node, dict):
            return {k: copy(v, index) for k, v in node.items()}
        return torch.tensor(np.asarray(node)[index], device=device)

    params = {k: copy(tree[k]) for k in ("embed", "lm_head", "final_norm",
                                         "shared_attn") if k in tree}
    blocks = tree["blocks"]
    if cfg.arch_type == "ssm":
        params["blocks"] = [copy(blocks, (i,)) for i in range(cfg.num_layers)]
    else:
        every = cfg.hybrid_attn_every
        n_groups, rem = divmod(cfg.num_layers, every)
        params["blocks"] = [[copy(blocks, (g, i)) for i in range(every)]
                            for g in range(n_groups)]
        if rem:
            params["tail_blocks"] = [copy(tree["tail_blocks"], (i,))
                                     for i in range(rem)]
    return params


# ======================================================================
# Forward (train / prefill)
# ======================================================================
def _dense_block(bp, cfg: ArchConfig, x, positions):
    x = x + attn.attention(bp["attn"], cfg,
                           layers.rmsnorm(bp["ln1"], x, cfg.rmsnorm_eps),
                           positions)
    y = layers.rmsnorm(bp["ln2"], x, cfg.rmsnorm_eps)
    return x + layers.mlp(bp["mlp"], y)


def _ssm_block(bp, cfg: ArchConfig, x):
    h, _ = ssm_lib.ssm_forward(bp["ssm"], cfg,
                               layers.rmsnorm(bp["ln"], x, cfg.rmsnorm_eps))
    return x + h


def forward_features(params: Params, cfg: ArchConfig, batch):
    """batch: {"tokens": (b, s) ints, a tensor or array}; the tokens go to
    the device of the embedding table.  ``ssm`` and ``hybrid`` archs.

    Returns (final hidden states (b, s, d_model), aux loss dict): both
    families have no auxiliary losses, so the dict is empty, as in the
    JAX package.
    """
    _check_token_model(cfg, "forward_features")
    table = params["embed"]["table"]
    tokens = torch.as_tensor(batch["tokens"], device=table.device).long()
    x = layers.embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)

    if cfg.arch_type == "ssm":
        for bp in params["blocks"]:
            x = _ssm_block(bp, cfg, x)
    else:
        shared = params["shared_attn"]
        for group in params["blocks"]:
            for bp in group:
                x = _ssm_block(bp, cfg, x)
            x = _dense_block(shared, cfg, x, positions)
        for bp in params.get("tail_blocks", ()):
            x = _ssm_block(bp, cfg, x)
    return layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps), {}


def unembed_table(params: Params, cfg: ArchConfig):
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["lm_head"]["table"])


def mask_pad_logits(logits, cfg: ArchConfig):
    """Vocab-pad entries get -1e30 so softmax/argmax ignore them."""
    if cfg.padded_vocab_size == cfg.vocab_size:
        return logits
    valid = torch.arange(cfg.padded_vocab_size,
                         device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits,
                       torch.full_like(logits, -1e30))


def forward_embedded(params: Params, cfg: ArchConfig, x):
    """Dense-stack forward over PRE-EMBEDDED inputs.

    x: (b, s, d_model) — e.g. projected observations rather than token
    embeddings.  Runs ``params["blocks"]`` + final norm and returns the
    features (b, s, d_model); the dense stack has no auxiliary losses.
    """
    _check_dense(cfg, "forward_embedded")
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
