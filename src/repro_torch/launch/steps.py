"""Step functions over the model zoo.

``prefill_step`` scores full sequences: actor-side batched inference, the
greedy action at every position and the logits at the last one.  The
learner's ``train_step``, the token-by-token ``serve_step`` and the batched
prefill into a decode cache come with their slices.
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
