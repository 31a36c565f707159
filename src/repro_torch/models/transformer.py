"""Unified model zoo: dense/GQA, MoE, Mamba2-SSM, Zamba2-hybrid, VLM,
Whisper: the forward pass, batched prefill and token-by-token decode.

Plain functions over a dict of tensors.  The JAX package stacks per-layer
parameters along a leading ``layers`` axis and scans over it; here
``params["blocks"]`` (and a Whisper model's ``enc_blocks``) is a LIST of
per-layer dicts (same leaf names, no layer axis) and the layers run in a
Python loop.  An MoE layer's expert bank stays stacked on its expert axis.
A hybrid model's blocks are a list of groups, each a list of
``hybrid_attn_every`` Mamba2 layers, followed by ``tail_blocks`` and one
``shared_attn`` block applied after every group.

Decode caches keep the reference's layouts, leaf names, shapes and dtypes
(``init_cache``): stacked leaves with a leading layers axis (``(groups,
every, ...)`` for the hybrid's Mamba2 layers), or ``"kv_list"``, one
cache per layer.  Each layer reads and updates a view of its own slice IN
PLACE (the JAX package returns updated copies); every entry point still
returns the cache.

Public API:
  init(generator, cfg, device, dtype)              -> params
  params_from_jax(cfg, tree, device)               -> params
  params_to_jax(cfg, params)                       -> the JAX layout
  forward_features(params, cfg, batch, remat)      -> (features, aux)
  forward(params, cfg, batch, remat)               -> (logits, aux)
  unembed_table(params, cfg), mask_pad_logits(logits, cfg)
  forward_embedded(params, cfg, x, remat)          -> features (dense, MoE)
  init_cache(cfg, batch, max_len, dtype, device)   -> decode cache
  decode_step(params, cfg, cache, token, pos)      -> (logits, cache)
  prefill(params, cfg, cache, tokens, lengths)     -> (last logits, cache)
  prefill_embedded(params, cfg, cache, x, lengths) -> (features, cache)
  decode_step_embedded(params, cfg, cache, x, pos) -> (features, cache)

The ``*_embedded`` entry points' ``params`` hold ``"blocks"`` and
``"final_norm"``; ``repro_torch.policies.network`` adds the observation
projection and the Q head around them.

``remat`` picks what a training step keeps for its backward, at the JAX
package's granularity (one checkpoint a block of the dense, MoE, VLM, SSM
and audio stacks, one a group of the hybrid's, one a tail block):
``"none"`` keeps everything, ``"full"`` only each checkpoint's inputs
(``torch.utils.checkpoint``, non-reentrant: the block runs again in the
backward, its kernels included), ``"dots"`` also the outputs of products
without batch dimensions (``jax.checkpoint_policies.
checkpoint_dots_with_no_batch_dims``).  It applies only under grad mode,
so scoring and serving run as they are.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig
from repro_torch.sharding import shard

Params = Dict[str, Any]
DENSE_FAMILY = ("dense", "moe", "vlm")


def _save_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims`` on aten ops: keep a product
    with no batch dimension, recompute the rest.  ``torch.einsum`` lowers
    every product of the zoo to ``aten.bmm``; a projection (``bsd,dhk``,
    the MLP, the router, the unembed) becomes one of batch 1, while
    attention's q.k and p.v, the SSD's chunk products and the expert bank
    (batched over experts, as in the JAX package) keep their batch."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str):
    """``fn`` under ``remat`` ("none", "full" or "dots"); as it is when
    grad mode is off."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(remat)
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _save_dots))


def _check_arch(cfg: ArchConfig, what: str, families=("dense", "moe")):
    if cfg.arch_type not in families:
        raise ValueError(f"{what} supports {'/'.join(families)} archs, got "
                         f"{cfg.arch_type}")


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
    _check_arch(cfg, "init_blocks", ("dense",))
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


def params_to_jax(cfg: ArchConfig, params: Params):
    """``params_from_jax``'s inverse: a tree of the port's layout (params,
    or an optimizer's moments over them) as the JAX package's
    ``transformer.init`` lays it out, with numpy leaves on the host:
    ``blocks`` and ``enc_blocks`` stacked on a leading layer axis
    (``(groups, every)`` for ``hybrid``), ``tail_blocks`` on its own."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        if isinstance(node, list):
            return stack([host(v) for v in node])
        return node.detach().cpu().numpy()

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    if cfg.arch_type not in DENSE_FAMILY + ("ssm", "hybrid", "audio"):
        raise ValueError(cfg.arch_type)
    return host(params)


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


def _act_seq(x):
    """The sequence-parallel residual stream between blocks (Megatron SP):
    a checkpoint's carry is then 1/model_parallel the size."""
    return shard(x, "batch", "act_seq", "d_model")


def _ssm_layer(bp, cfg: ArchConfig, x):
    return _act_seq(_ssm_block(bp, cfg, x))


def _stack_block(bp, cfg: ArchConfig, x, positions, aux, *, causal=True):
    x, aux = _dense_block(bp, cfg, x, positions, aux, causal=causal)
    return _act_seq(x), aux


def _run_dense_stack(blocks, cfg: ArchConfig, x, positions, remat="none",
                     causal=True):
    """The blocks in turn, one checkpoint a block under ``remat``; an MoE
    stack's aux losses summed over its layers from float32 zeros."""
    aux = ({name: torch.zeros((), device=x.device)
            for name in ("moe_aux", "moe_z")}
           if cfg.arch_type == "moe" else {})
    for bp in blocks:
        block = functools.partial(_stack_block, bp, cfg, causal=causal)
        x, aux = _maybe_remat(block, remat)(x, positions, aux)
    return x, aux


def _hybrid_group(group, shared, cfg: ArchConfig, positions, x):
    """One of the hybrid's groups: its Mamba2 layers, then the shared
    attention block."""
    for bp in group:
        x = _ssm_layer(bp, cfg, x)
    return _act_seq(_dense_block(shared, cfg, x, positions, {})[0])


def _whisper_decoder_block(bp, cfg: ArchConfig, positions, enc, x):
    # per-layer cross K/V from the encoder output
    k = torch.einsum("bsd,dhk->bshk", enc, bp["xattn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc, bp["xattn"]["wv"])
    return _dense_block(bp, cfg, x, positions, {}, enc=(k, v))[0]


def forward_features(params: Params, cfg: ArchConfig, batch, *,
                     remat: str = "full"):
    """batch: {"tokens": (b, s) ints} (+ "vision": (b, V, d_model) for a
    VLM | "frames": (b, encoder_seq, d_model) for Whisper), tensors or
    arrays: they go to the device of the embedding table, vision and
    frames in its dtype.

    Returns (final hidden states at text positions (b, s, d_model), aux
    loss dict): ``moe_aux`` and ``moe_z`` summed over layers for MoE, empty
    for every other family, as in the JAX package.  ``remat`` applies
    under grad mode only (module docstring).
    """
    table = params["embed"]["table"]

    def on_table(name):
        return torch.as_tensor(batch[name]).to(table.device, table.dtype)

    tokens = torch.as_tensor(batch["tokens"], device=table.device).long()
    x = layers.embed(params["embed"], tokens)
    if cfg.arch_type == "vlm":                # projected patch embeddings
        vision = on_table("vision")
        x = torch.cat([vision, x], dim=1)
    x = shard(x, "batch", "seq", "d_model")
    seq = x.shape[1]
    positions = torch.arange(seq, device=x.device)
    aux: Dict[str, torch.Tensor] = {}

    def run(fn, *args):                    # fn(*args, x) under remat
        return _maybe_remat(functools.partial(fn, *args), remat)

    if cfg.arch_type in DENSE_FAMILY:
        x, aux = _run_dense_stack(params["blocks"], cfg, x, positions, remat)
    elif cfg.arch_type == "ssm":
        for bp in params["blocks"]:
            x = run(_ssm_layer, bp, cfg)(x)
    elif cfg.arch_type == "hybrid":
        for group in params["blocks"]:
            x = run(_hybrid_group, group, params["shared_attn"], cfg,
                    positions)(x)
        for bp in params.get("tail_blocks", ()):
            x = run(_ssm_block, bp, cfg)(x)
    elif cfg.arch_type == "audio":
        frames = on_table("frames")
        enc = frames + layers.sinusoid_positions(
            frames.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        enc_pos = torch.arange(enc.shape[1], device=x.device)
        enc, _ = _run_dense_stack(params["enc_blocks"], cfg, enc, enc_pos,
                                  remat, causal=False)
        enc = layers.rmsnorm(params["enc_norm"], enc, cfg.rmsnorm_eps)
        x = x + layers.sinusoid_positions(seq, cfg.d_model,
                                          x.device).to(x.dtype)[None]
        for bp in params["blocks"]:
            x = run(_whisper_decoder_block, bp, cfg, positions, enc)(x)
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


def forward(params: Params, cfg: ArchConfig, batch, *, remat: str = "full"):
    """Full logits over all (text) positions: (b, s, padded_V), vocab pad
    masked, and the aux loss dict."""
    x, aux = forward_features(params, cfg, batch, remat=remat)
    logits = layers.unembed(unembed_table(params, cfg), x)
    logits = mask_pad_logits(logits, cfg)
    return shard(logits, "batch", "seq", "vocab"), aux


def forward_embedded(params: Params, cfg: ArchConfig, x, *,
                     remat: str = "none"):
    """Dense-stack forward over PRE-EMBEDDED inputs.

    x: (b, s, d_model) — e.g. projected observations rather than token
    embeddings.  Runs ``params["blocks"]`` + final norm and returns the
    features (b, s, d_model); an MoE stack's auxiliary losses, which the
    JAX package returns beside them and its callers drop, are not kept.
    """
    _check_arch(cfg, "forward_embedded")
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_dense_stack(params["blocks"], cfg, x, positions, remat)
    return layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)


# ======================================================================
# Decode
# ======================================================================
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", layout: str = "stacked"):
    """Per-layer decode caches, zeros, with the JAX package's leaf names,
    shapes and dtypes.

    Dense, MoE and VLM: ``{"kv": {"k", "v"}}`` with leaves (layers, batch,
    length, kv_heads, head_dim), or with ``layout="list"`` ``{"kv_list":
    [{"k", "v"}, ...]}``, one cache per layer.  SSM: ``{"ssm": {"state",
    "conv"}}`` (float32, as ``ssm.init_ssm_cache``'s default).  Hybrid:
    ``"ssm"`` with leaves (groups, every, ...), ``"attn_kv"`` with one KV
    cache per shared-attention site (the sites share the block's params,
    not its caches) and, when ``num_layers % every``, ``"tail_ssm"``.
    Audio: ``"kv"`` and the cross-attention K/V ``"cross_k"`` and
    ``"cross_v"`` (layers, batch, encoder_seq, kv_heads, head_dim), which
    stay zeros: nothing in the JAX package fills them.  ``layout`` applies
    to the dense family only.  Sliding-window archs use a ring of the
    window's length.
    """
    def stack(lead, one):
        return {name: torch.zeros(lead + t.shape, dtype=t.dtype,
                                  device=device)
                for name, t in one.items()}

    def kv():
        return attn.init_kv_cache(cfg, batch, max_len, dtype, device)

    def ssm():
        return ssm_lib.init_ssm_cache(cfg, batch, device=device)

    if cfg.arch_type in DENSE_FAMILY:
        if layout == "list":
            return {"kv_list": [kv() for _ in range(cfg.num_layers)]}
        return {"kv": stack((cfg.num_layers,), kv())}
    if cfg.arch_type == "ssm":
        return {"ssm": stack((cfg.num_layers,), ssm())}
    if cfg.arch_type == "hybrid":
        every = cfg.hybrid_attn_every
        n_groups, rem = divmod(cfg.num_layers, every)
        cache = {"ssm": stack((n_groups, every), ssm()),
                 "attn_kv": stack((n_groups,), kv())}
        if rem:
            cache["tail_ssm"] = stack((rem,), ssm())
        return cache
    if cfg.arch_type == "audio":
        cross = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"kv": stack((cfg.num_layers,), kv()),
                "cross_k": torch.zeros(cross, dtype=dtype, device=device),
                "cross_v": torch.zeros(cross, dtype=dtype, device=device)}
    raise ValueError(cfg.arch_type)


def _slice(tree, *index):
    """Views of every leaf of a cache dict at ``index`` on its leading
    axes: writes through them land in the stacked cache."""
    return {name: t[index] for name, t in tree.items()}


def _dense_caches(cache, num_layers):
    """Each layer's KV cache of a dense-family cache, in either layout."""
    if "kv_list" in cache:
        return cache["kv_list"]
    return [_slice(cache["kv"], i) for i in range(num_layers)]


def _ffn(bp, cfg, y):
    if cfg.arch_type == "moe":
        return moe_lib.moe_ffn(bp["moe"], cfg, y)[0]
    return layers.mlp(bp["mlp"], y)


def _decode_dense_block(bp, cfg, x, kv_cache, pos, cross_kv=None,
                        backend="grouped"):
    h, kv_cache = attn.decode_attention(
        bp["attn"], cfg, layers.rmsnorm(bp["ln1"], x, cfg.rmsnorm_eps),
        kv_cache, pos, backend=backend)
    x = x + h
    if cross_kv is not None:
        h, _ = attn.decode_attention(
            bp["xattn"], cfg, layers.rmsnorm(bp["lnx"], x, cfg.rmsnorm_eps),
            None, pos, cross_kv=cross_kv, backend=backend)
        x = x + h
    y = layers.rmsnorm(bp["ln2"], x, cfg.rmsnorm_eps)
    return x + _ffn(bp, cfg, y), kv_cache


def _prefill_dense_block(bp, cfg, x, kv_cache, positions, lengths=None):
    """``_decode_dense_block``'s batched-prompt twin: the whole prompt's K/V
    lands in the cache in one attention call, not one call per token."""
    h, kv_cache = attn.prefill_attention(
        bp["attn"], cfg, layers.rmsnorm(bp["ln1"], x, cfg.rmsnorm_eps),
        kv_cache, positions, lengths=lengths)
    x = x + h
    y = layers.rmsnorm(bp["ln2"], x, cfg.rmsnorm_eps)
    return x + _ffn(bp, cfg, y), kv_cache


def _decode_ssm_block(bp, cfg, x, cache):
    h, cache = ssm_lib.ssm_step(
        bp["ssm"], cfg, layers.rmsnorm(bp["ln"], x, cfg.rmsnorm_eps), cache)
    return x + h, cache


def decode_positional(pos, d_model: int, device):
    """Whisper's decode-time sinusoid at scalar ``pos``: (d_model,) float32,
    sin at even channels, cos at odd, with the angle pos / 10000^(2i/d) by
    division, as the JAX package's ``decode_step`` writes it inline (its
    full-sequence twin is ``layers.sinusoid_positions``)."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    angle = torch.as_tensor(pos, device=device).float() / torch.pow(
        10000.0, dim / d_model)
    # interleaved by a stack, not written into zeros: a scalar ``pos``
    # may be a DTensor, which cannot be written into a plain tensor
    return torch.stack([torch.sin(angle), torch.cos(angle)],
                       dim=-1).reshape(d_model)


def decode_step(params: Params, cfg: ArchConfig, cache, token, pos, *,
                backend: str = "grouped"):
    """One token for every row: token (b, 1) ints; pos a scalar (or (b,)
    per-row positions for the dense family; Whisper's positional term is
    one row, so audio takes a scalar only).  Updates the cache in place.
    Returns (logits (b, padded_V), cache).

    ``backend`` picks the decode-attention path (``attention.
    _decode_backend``) of every attention call: the dense family's layers,
    the hybrid's shared-attention sites and Whisper's self- and
    cross-attention (the JAX package passes it to the dense family's only;
    the paths compute the same function)."""
    table = params["embed"]["table"]
    token = torch.as_tensor(token, device=table.device).long()
    x = layers.embed(params["embed"], token)
    x = shard(x, "batch", None, "d_model")
    pos = torch.as_tensor(pos, device=x.device)

    if cfg.arch_type in DENSE_FAMILY:
        for bp, kv in zip(params["blocks"],
                          _dense_caches(cache, cfg.num_layers)):
            x, _ = _decode_dense_block(bp, cfg, x, kv, pos, backend=backend)
    elif cfg.arch_type == "ssm":
        for i, bp in enumerate(params["blocks"]):
            x, _ = _decode_ssm_block(bp, cfg, x, _slice(cache["ssm"], i))
    elif cfg.arch_type == "hybrid":
        shared = params["shared_attn"]
        for g, group in enumerate(params["blocks"]):
            for j, bp in enumerate(group):
                x, _ = _decode_ssm_block(bp, cfg, x,
                                         _slice(cache["ssm"], g, j))
            x, _ = _decode_dense_block(shared, cfg, x,
                                       _slice(cache["attn_kv"], g), pos,
                                       backend=backend)
        for i, bp in enumerate(params.get("tail_blocks", ())):
            x, _ = _decode_ssm_block(bp, cfg, x, _slice(cache["tail_ssm"], i))
    elif cfg.arch_type == "audio":
        if pos.dim() != 0:
            raise ValueError("audio decode_step takes a scalar pos: the "
                             "positional term is one row for the batch")
        x = x + decode_positional(pos, cfg.d_model, x.device).to(x.dtype)
        for i, bp in enumerate(params["blocks"]):
            x, _ = _decode_dense_block(
                bp, cfg, x, _slice(cache["kv"], i), pos,
                cross_kv=(cache["cross_k"][i], cache["cross_v"][i]),
                backend=backend)
    else:
        raise ValueError(cfg.arch_type)

    x = layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    logits = layers.unembed(unembed_table(params, cfg), x)[:, 0]
    return shard(mask_pad_logits(logits, cfg), "batch", "vocab"), cache


def prefill_embedded(params: Params, cfg: ArchConfig, cache, x, *,
                     lengths=None):
    """Batched prompt prefill over PRE-EMBEDDED inputs.

    x: (b, s, d_model) with s <= cache length; rows shorter than ``s`` are
    right-padded and masked out via ``lengths`` (b,) int.  The whole
    prompt's K/V lands in the cache (in place) in ONE call per layer, so
    decode can continue at position ``lengths[i]`` without per-token replay.
    Stacked ``"kv"`` layout, dense and MoE archs.  Attention runs as
    ``attention.prefill_attention`` runs it: flash attention on the card,
    the masked softmax on the CPU.

    Returns (features (b, s, d_model), cache).
    """
    _check_arch(cfg, "prefill_embedded")
    if "kv" not in cache:
        raise ValueError("prefill_embedded needs the stacked 'kv' cache layout")
    positions = torch.arange(x.shape[1], device=x.device)
    for i, bp in enumerate(params["blocks"]):
        x, _ = _prefill_dense_block(bp, cfg, x, _slice(cache["kv"], i),
                                    positions, lengths=lengths)
    return layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps), cache


def decode_step_embedded(params: Params, cfg: ArchConfig, cache, x, pos, *,
                         backend: str = "grouped"):
    """Incremental decode over PRE-EMBEDDED inputs.

    x: (b, 1, d_model); pos: scalar or per-row (b,) positions (continuous
    batching — each row advances independently).  Stacked ``"kv"`` layout,
    dense and MoE archs.  Updates the cache in place.  Returns (features
    (b, d_model), cache).
    """
    _check_arch(cfg, "decode_step_embedded")
    if "kv" not in cache:
        raise ValueError(
            "decode_step_embedded needs the stacked 'kv' cache layout")
    for i, bp in enumerate(params["blocks"]):
        x, _ = _decode_dense_block(bp, cfg, x, _slice(cache["kv"], i), pos,
                                   backend=backend)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    return x[:, 0], cache


def prefill(params: Params, cfg: ArchConfig, cache, tokens, *, lengths=None):
    """Batched token prefill: embed, run the stack through the cache, and
    return next-token logits at each row's last REAL token.

    tokens: (b, s) ints, right-padded; lengths: (b,) real lengths (None
    means every row uses all ``s`` tokens).  Dense and MoE archs with the
    stacked ``"kv"`` cache layout.  On the card each layer's attention is
    one flash-attention call.

    Returns (logits (b, padded_V), cache) — decode continues at position
    ``lengths[i]`` (or ``s``).
    """
    table = params["embed"]["table"]
    tokens = torch.as_tensor(tokens, device=table.device).long()
    x = layers.embed(params["embed"], tokens)
    x = shard(x, "batch", None, "d_model")
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x.device)
    feats, cache = prefill_embedded(params, cfg, cache, x, lengths=lengths)
    if lengths is None:
        last = feats[:, -1]
    else:
        rows = torch.arange(feats.shape[0], device=x.device)
        last = feats[rows, torch.clamp(lengths.long() - 1, min=0)]
    logits = layers.unembed(unembed_table(params, cfg), last)
    return shard(mask_pad_logits(logits, cfg), "batch", "vocab"), cache
