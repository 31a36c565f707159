"""Architecture + input-shape registry (a copy of ``repro.configs``).

``get_arch(name)`` resolves any of the 10 assigned architectures;
``reduced(cfg)`` produces the CPU-smoke variant (2 layers, d_model<=512,
<=4 experts) of the same family used by the per-arch smoke tests.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig, InputShape, MoEConfig, SSMConfig, INPUT_SHAPES

from repro_torch.configs.codeqwen1_5_7b import CONFIG as CODEQWEN15_7B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B
from repro_torch.configs.yi_6b import CONFIG as YI_6B
from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN3_1_7B
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE_A2_7B
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B
from repro_torch.configs.mamba2_780m import CONFIG as MAMBA2_780M
from repro_torch.configs.whisper_base import CONFIG as WHISPER_BASE
from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK_7B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B_A800M

ARCHS = {
    c.name: c
    for c in (
        CODEQWEN15_7B,
        ZAMBA2_1_2B,
        YI_6B,
        QWEN3_1_7B,
        QWEN2_MOE_A2_7B,
        INTERNVL2_26B,
        MAMBA2_780M,
        WHISPER_BASE,
        DEEPSEEK_7B,
        GRANITE_MOE_3B_A800M,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests."""
    d_model = min(cfg.d_model, 256)
    head_dim = 32 if cfg.head_dim else 0
    num_heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    num_kv = min(cfg.num_kv_heads, max(1, num_heads // 2)) if cfg.num_kv_heads else 0
    # keep GQA shape legal
    if num_heads and num_kv:
        while num_heads % num_kv:
            num_kv -= 1
    updates = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=None,
    )
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_expert=64,
            num_shared=min(cfg.moe.num_shared, 1))
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=32)
    if cfg.hybrid_attn_every:
        updates["hybrid_attn_every"] = 1
    if cfg.encoder_layers:
        updates["encoder_layers"] = 2
        updates["encoder_seq"] = 16
    if cfg.vision_tokens:
        updates["vision_tokens"] = 8
    return dataclasses.replace(cfg, **updates)


__all__ = [
    "ARCHS", "get_arch", "get_shape", "reduced",
    "ArchConfig", "InputShape", "MoEConfig", "SSMConfig", "INPUT_SHAPES",
]
