"""Unified model zoo: dense/GQA, MoE, Mamba2-SSM, Zamba2-hybrid, VLM,
Whisper, the forward pass of each; the dense stack's decode over
pre-embedded inputs.

Plain functions over a dict of tensors.  The JAX package stacks per-layer
parameters along a leading ``layers`` axis and scans over it; here
``params["blocks"]`` (and a Whisper model's ``enc_blocks``) is a LIST of
per-layer dicts (same leaf names, no layer axis) and the layers run in a
Python loop.  An MoE layer's expert bank stays stacked on its expert axis.
A hybrid model's blocks are a list of groups, each a list of
``hybrid_attn_every`` Mamba2 layers, followed by ``tail_blocks`` and one
``shared_attn`` block applied after every group.  The decode cache keeps
the reference's stacked layout, ``{"kv": {"k", "v"}}`` with leaves
``(layers, batch, length, kv_heads, head_dim)``, and each layer updates
its row of it in place.

Public API:
  init(generator, cfg, device, dtype)              -> params
  params_from_jax(cfg, tree, device)               -> params
  forward_features(params, cfg, batch)             -> (features, aux)
  forward(params, cfg, batch)                      -> (logits, aux)
  unembed_table(params, cfg), mask_pad_logits(logits, cfg)
  forward_embedded(params, cfg, x)                 -> features (dense)
  init_cache(cfg, batch, max_len, dtype, device)   -> decode cache (dense)
  prefill_embedded(params, cfg, cache, x, lengths) -> (features, cache)
  decode_step_embedded(params, cfg, cache, x, pos) -> (features, cache)

The ``*_embedded`` entry points' ``params`` hold ``"blocks"`` and
``"final_norm"``; ``repro_torch.policies.network`` adds the observation
projection and the Q head around them.  Token-by-token decoding of every
family, the MoE family's ``*_embedded`` entry points, and ``remat`` (a
forward-only port has nothing to rematerialize) come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]
DENSE_FAMILY = ("dense", "moe", "vlm")


def _check_dense(cfg: ArchConfig, what: str):
    if cfg.arch_type != "dense":
        raise ValueError(f"{what} supports dense archs, got {cfg.arch_type}")


# ======================================================================
# Init
# ======================================================================
def _dense_block_init(generator, cfg: ArchConfig, device="cuda",
                      dtype=torch.float32):
    p = {
        "ln1": layers.rmsnorm_init(cfg.d_model, device, dtype),
        "attn": attn.attn_init(generator, cfg, device, dtype),
        "ln2": layers.rmsnorm_init(cfg.d_model, device, dtype),
    }
    if cfg.arch_type == "moe":
        p["moe"] = moe_lib.moe_init(generator, cfg, device, dtype)
    else:
        p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff, device,
                                   dtype)
    return p


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


def _xattn_block_init(generator, cfg: ArchConfig, device="cuda",
                      dtype=torch.float32):
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, device, dtype),
        "attn": attn.attn_init(generator, cfg, device, dtype),
        "lnx": layers.rmsnorm_init(cfg.d_model, device, dtype),
        "xattn": attn.attn_init(generator, cfg, device, dtype),
        "ln2": layers.rmsnorm_init(cfg.d_model, device, dtype),
        "mlp": layers.mlp_init(generator, cfg.d_model, cfg.d_ff, device,
                               dtype),
    }


def init(generator, cfg: ArchConfig, device="cuda", dtype=torch.float32
         ) -> Params:
    """Random params drawn from ``generator`` (on its own device: a CUDA
    generator draws a large model on the card) and moved to ``device`` a
    tensor at a time."""
    pv = cfg.padded_vocab_size
    params: Params = {
        "embed": layers.embed_init(generator, pv, cfg.d_model, device, dtype),
        "final_norm": layers.rmsnorm_init(cfg.d_model, device, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.embed_init(generator, pv, cfg.d_model,
                                              device, dtype)

    def blocks(block_init, count):
        return [block_init(generator, cfg, device, dtype)
                for _ in range(count)]

    if cfg.arch_type in DENSE_FAMILY:
        params["blocks"] = blocks(_dense_block_init, cfg.num_layers)
    elif cfg.arch_type == "ssm":
        params["blocks"] = blocks(_ssm_block_init, cfg.num_layers)
    elif cfg.arch_type == "hybrid":
        every = cfg.hybrid_attn_every
        n_groups, rem = divmod(cfg.num_layers, every)
        params["blocks"] = [blocks(_ssm_block_init, every)
                            for _ in range(n_groups)]
        if rem:
            params["tail_blocks"] = blocks(_ssm_block_init, rem)
        # one weight set, applied after every group
        params["shared_attn"] = _dense_block_init(generator, cfg, device,
                                                  dtype)
    elif cfg.arch_type == "audio":
        params["enc_blocks"] = blocks(_dense_block_init, cfg.encoder_layers)
        params["enc_norm"] = layers.rmsnorm_init(cfg.d_model, device, dtype)
        params["blocks"] = blocks(_xattn_block_init, cfg.num_layers)
    else:
        raise ValueError(cfg.arch_type)
    return params


def params_from_jax(cfg: ArchConfig, tree, device="cuda") -> Params:
    """The JAX package's ``transformer.init`` tree (numpy leaves) in the
    port's layout: ``blocks`` and ``enc_blocks`` unstacked on their layer
    axis into per-layer dicts (a list of groups of them for ``hybrid``;
    an MoE expert bank keeps its expert axis), ``tail_blocks`` into a
    list, and ``shared_attn``, ``embed``, ``lm_head``, ``final_norm`` and
    ``enc_norm`` copied name for name."""
    if cfg.arch_type not in DENSE_FAMILY + ("ssm", "hybrid", "audio"):
        raise ValueError(cfg.arch_type)

    def copy(node, index=()):
        if isinstance(node, dict):
            return {k: copy(v, index) for k, v in node.items()}
        return torch.tensor(np.asarray(node)[index], device=device)

    def unstack(node, count):
        return [copy(node, (i,)) for i in range(count)]

    params = {k: copy(tree[k]) for k in ("embed", "lm_head", "final_norm",
                                         "shared_attn", "enc_norm")
              if k in tree}
    blocks = tree["blocks"]
    if cfg.arch_type == "hybrid":
        every = cfg.hybrid_attn_every
        n_groups, rem = divmod(cfg.num_layers, every)
        params["blocks"] = [[copy(blocks, (g, i)) for i in range(every)]
                            for g in range(n_groups)]
        if rem:
            params["tail_blocks"] = unstack(tree["tail_blocks"], rem)
    else:
        params["blocks"] = unstack(blocks, cfg.num_layers)
    if cfg.arch_type == "audio":
        params["enc_blocks"] = unstack(tree["enc_blocks"], cfg.encoder_layers)
    return params


# ======================================================================
# Forward (train / prefill)
# ======================================================================
def _dense_block(bp, cfg: ArchConfig, x, positions, aux, *, causal=True,
                 enc=None):
    """One dense-family block; ``enc`` = (k, v) adds Whisper's
    cross-attention.  Returns (x, aux) with an MoE layer's losses added."""
    x = x + attn.attention(bp["attn"], cfg,
                           layers.rmsnorm(bp["ln1"], x, cfg.rmsnorm_eps),
                           positions, causal=causal)
    if enc is not None:
        x = x + attn.attention(bp["xattn"], cfg,
                               layers.rmsnorm(bp["lnx"], x, cfg.rmsnorm_eps),
                               positions, causal=False, kv=enc)
    y = layers.rmsnorm(bp["ln2"], x, cfg.rmsnorm_eps)
    if cfg.arch_type == "moe":
        f, losses = moe_lib.moe_ffn(bp["moe"], cfg, y)
        aux = {k: aux[k] + v for k, v in losses.items()}
    else:
        f = layers.mlp(bp["mlp"], y)
    return x + f, aux


def _ssm_block(bp, cfg: ArchConfig, x):
    h, _ = ssm_lib.ssm_forward(bp["ssm"], cfg,
                               layers.rmsnorm(bp["ln"], x, cfg.rmsnorm_eps))
    return x + h


def _run_dense_stack(blocks, cfg: ArchConfig, x, positions, causal=True):
    """The blocks in turn; an MoE stack's aux losses summed over its layers
    from float32 zeros."""
    aux = ({name: torch.zeros((), device=x.device)
            for name in ("moe_aux", "moe_z")}
           if cfg.arch_type == "moe" else {})
    for bp in blocks:
        x, aux = _dense_block(bp, cfg, x, positions, aux, causal=causal)
    return x, aux


def forward_features(params: Params, cfg: ArchConfig, batch):
    """batch: {"tokens": (b, s) ints} (+ "vision": (b, V, d_model) for a
    VLM | "frames": (b, encoder_seq, d_model) for Whisper), tensors or
    arrays: they go to the device of the embedding table, vision and
    frames in its dtype.

    Returns (final hidden states at text positions (b, s, d_model), aux
    loss dict): ``moe_aux`` and ``moe_z`` summed over layers for MoE, empty
    for every other family, as in the JAX package.
    """
    table = params["embed"]["table"]

    def on_table(name):
        return torch.as_tensor(batch[name]).to(table.device, table.dtype)

    tokens = torch.as_tensor(batch["tokens"], device=table.device).long()
    x = layers.embed(params["embed"], tokens)
    if cfg.arch_type == "vlm":                # projected patch embeddings
        vision = on_table("vision")
        x = torch.cat([vision, x], dim=1)
    seq = x.shape[1]
    positions = torch.arange(seq, device=x.device)
    aux: Dict[str, torch.Tensor] = {}

    if cfg.arch_type in DENSE_FAMILY:
        x, aux = _run_dense_stack(params["blocks"], cfg, x, positions)
    elif cfg.arch_type == "ssm":
        for bp in params["blocks"]:
            x = _ssm_block(bp, cfg, x)
    elif cfg.arch_type == "hybrid":
        shared = params["shared_attn"]
        for group in params["blocks"]:
            for bp in group:
                x = _ssm_block(bp, cfg, x)
            x, _ = _dense_block(shared, cfg, x, positions, {})
        for bp in params.get("tail_blocks", ()):
            x = _ssm_block(bp, cfg, x)
    elif cfg.arch_type == "audio":
        frames = on_table("frames")
        enc = frames + layers.sinusoid_positions(
            frames.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        enc_pos = torch.arange(enc.shape[1], device=x.device)
        enc, _ = _run_dense_stack(params["enc_blocks"], cfg, enc, enc_pos,
                                  causal=False)
        enc = layers.rmsnorm(params["enc_norm"], enc, cfg.rmsnorm_eps)
        x = x + layers.sinusoid_positions(seq, cfg.d_model,
                                          x.device).to(x.dtype)[None]
        for bp in params["blocks"]:
            # per-layer cross K/V from the encoder output
            k = torch.einsum("bsd,dhk->bshk", enc, bp["xattn"]["wk"])
            v = torch.einsum("bsd,dhk->bshk", enc, bp["xattn"]["wv"])
            x, _ = _dense_block(bp, cfg, x, positions, {}, enc=(k, v))
    else:
        raise ValueError(cfg.arch_type)

    x = layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    if cfg.arch_type == "vlm":                # only text positions score
        x = x[:, vision.shape[1]:]
    return x, aux


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


def forward(params: Params, cfg: ArchConfig, batch):
    """Full logits over all (text) positions: (b, s, padded_V), vocab pad
    masked, and the aux loss dict."""
    x, aux = forward_features(params, cfg, batch)
    logits = layers.unembed(unembed_table(params, cfg), x)
    return mask_pad_logits(logits, cfg), aux


def forward_embedded(params: Params, cfg: ArchConfig, x):
    """Dense-stack forward over PRE-EMBEDDED inputs.

    x: (b, s, d_model) — e.g. projected observations rather than token
    embeddings.  Runs ``params["blocks"]`` + final norm and returns the
    features (b, s, d_model); the dense stack has no auxiliary losses.
    """
    _check_dense(cfg, "forward_embedded")
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_dense_stack(params["blocks"], cfg, x, positions)
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
