"""Step functions over the model zoo.

``prefill_step`` scores full sequences: actor-side batched inference, the
greedy action at every position and the logits at the last one.
``serve_step`` decodes one token against a KV/SSM cache, and the batched
prefill step pushes a whole prompt through the cache in one call.  The
learner's ``train_step`` comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, transformer
from repro_torch.models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig, *, chunk: int = 1024):
    """Actor-side batched scoring: greedy actions per position + last-position
    logits, computed over seq chunks so full (b, s, V) logits never live.

    The step takes ``(params, {"tokens": (b, s)})``, plus ``"vision"``
    (b, V, d_model) for a VLM or ``"frames"`` (b, encoder_seq, d_model)
    for Whisper (moved to the device and dtype of the embedding table),
    and returns ``{"actions": (b, s) int32, "last_logits": (b,
    padded_V)}`` on the device of the params."""

    def prefill_step(params, batch):
        feats, _ = transformer.forward_features(params, cfg, batch)
        table = transformer.unembed_table(params, cfg)
        s = feats.shape[1]
        c = chunk if s % chunk == 0 else s
        actions = [
            torch.argmax(transformer.mask_pad_logits(
                layers.unembed(table, feats[:, i:i + c]), cfg), dim=-1)
            for i in range(0, s, c)]
        last_logits = transformer.mask_pad_logits(
            layers.unembed(table, feats[:, -1]), cfg)
        return {"actions": torch.cat(actions, dim=1).to(torch.int32),
                "last_logits": last_logits}

    return prefill_step


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def make_serve_step(cfg: ArchConfig, *, backend: str = "auto"):
    """One-token incremental decode against the cache: ``serve_step(params,
    cache, token (b, 1), pos) -> (next_token (b, 1) int32, logits (b,
    padded_V), cache)``, the cache updated in place.  ``backend`` selects
    the decode-attention path: ``"auto"`` (the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors), ``"kernel"``, ``"ref"`` or
    ``"grouped"`` (the grouped-GQA einsum, the JAX package's ``"jnp"``)."""

    def serve_step(params, cache, token, pos):
        logits, cache = transformer.decode_step(params, cfg, cache, token, pos,
                                                backend=backend)
        return _greedy(logits), logits, cache
    return serve_step


def make_batched_prefill_step(cfg: ArchConfig):
    """Whole-prompt prefill THROUGH the decode cache in one call — the
    batched replacement for stepping ``serve_step`` once per prompt token.
    Dense and MoE archs with the stacked ``"kv"`` cache layout only
    (``transformer.prefill`` raises otherwise).

    Returns ``prefill_step(params, cache, tokens, lengths=None) ->
    (next_token (b, 1) int32, logits (b, padded_V), cache)`` where
    ``tokens`` is right-padded (b, s) and ``lengths`` masks the padding;
    decode then continues at position ``lengths[i]`` (or ``s``)."""

    def prefill_step(params, cache, tokens, lengths=None):
        logits, cache = transformer.prefill(params, cfg, cache, tokens,
                                            lengths=lengths)
        return _greedy(logits), logits, cache
    return prefill_step
