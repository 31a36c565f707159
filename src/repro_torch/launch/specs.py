"""Fake-tensor input stand-ins for every (arch x input-shape) pair.

``input_specs(cfg, shape)`` returns the exact tree the corresponding step
function consumes, as tensors of ``FakeTensorMode`` (the JAX package's
``ShapeDtypeStruct``s): right shapes and dtypes, shardable, and
allocation-free.  Every spec of one call shares one mode, which the dry
run enters to trace a step over them (``fake_mode``).  Modality frontends
are stubs per the brief: VLM batches carry precomputed patch embeddings,
audio batches carry precomputed frame embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Optional
from unittest import mock

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models import layers, transformer
from repro_torch.models.config import ArchConfig, InputShape

Specs = Dict[str, Any]

_MODE: Optional[FakeTensorMode] = None


def fake_mode() -> FakeTensorMode:
    """The one ``FakeTensorMode`` every spec is made under (fake tensors
    of two modes cannot meet in one op)."""
    global _MODE
    if _MODE is None:
        _MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _MODE


def sds(shape, dtype):
    with fake_mode():
        return torch.empty(shape, dtype=dtype, device="cpu")


def train_specs(cfg: ArchConfig, shape: InputShape,
                act_dtype=torch.bfloat16) -> Specs:
    b, s = shape.global_batch, shape.seq_len
    text = s - cfg.vision_tokens if cfg.arch_type == "vlm" else s
    batch: Specs = {
        "tokens": sds((b, text), torch.int32),
        "labels": sds((b, text), torch.int32),
        "rewards": sds((b, text), torch.float32),
        "discounts": sds((b, text), torch.float32),
    }
    if cfg.arch_type == "vlm":
        batch["vision"] = sds((b, cfg.vision_tokens, cfg.d_model), act_dtype)
    if cfg.arch_type == "audio":
        batch["frames"] = sds((b, cfg.encoder_seq, cfg.d_model), act_dtype)
    return batch


def prefill_specs(cfg: ArchConfig, shape: InputShape,
                  act_dtype=torch.bfloat16) -> Specs:
    batch = train_specs(cfg, shape, act_dtype)
    return {k: v for k, v in batch.items()
            if k in ("tokens", "vision", "frames")}


def decode_specs(cfg: ArchConfig, shape: InputShape,
                 cache_dtype=torch.bfloat16, layout: str = "stacked") -> Specs:
    b, s = shape.global_batch, shape.seq_len
    if layout == "list" and cfg.arch_type not in ("dense", "moe", "vlm"):
        layout = "stacked"
    with fake_mode():
        cache = transformer.init_cache(cfg, b, s, cache_dtype, device="cpu",
                                       layout=layout)
    return {
        "cache": cache,
        "token": sds((b, 1), torch.int32),
        "pos": sds((), torch.int32),
    }


def _no_draw(generator, shape, stddev, device="cuda", dtype=torch.float32):
    """``layers.truncated_normal``'s tensor without its draw, whose
    rejection loop asks for values a fake tensor does not have."""
    return torch.empty(shape, dtype=dtype, device=device)


def params_specs(cfg: ArchConfig, param_dtype=torch.bfloat16):
    """``transformer.init``'s tree, run under the fake mode with its
    draws replaced by empty tensors of the same shapes and dtypes (the
    JAX package's ``jax.eval_shape`` of init)."""
    with fake_mode(), mock.patch.object(layers, "truncated_normal",
                                        _no_draw):
        return transformer.init(torch.Generator(), cfg, "cpu", param_dtype)


def input_specs(cfg: ArchConfig, shape: InputShape, **kw) -> Specs:
    if shape.kind == "train":
        return train_specs(cfg, shape, **kw)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape, **kw)
    return decode_specs(cfg, shape, **kw)
