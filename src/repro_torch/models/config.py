"""Architecture configuration for the assigned model pool.

One frozen dataclass describes every family we support: dense/GQA decoders,
MoE, Mamba2 SSM, Zamba2-style hybrids, VLM decoders with stubbed vision
frontends, and Whisper-style encoder-decoders (a copy of
``repro.models.config``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    d_expert: int               # per-expert ffn hidden size
    num_shared: int = 0         # always-on shared experts (same d_expert)
    capacity_factor: float = 1.25
    group_size: int = 256       # tokens per dispatch group (perf knob: the
                                # dispatch einsum costs g*k*cf*D MACs/token)
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-4


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int                # N — SSM state size per head
    head_dim: int = 64          # P — channels per SSM head
    expand: int = 2             # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256       # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str              # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int              # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int                   # dense ffn hidden (0 when pure MoE / ssm)
    vocab_size: int
    head_dim: int = 128
    # Attention flavour
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # set => banded attention
    # Family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: indices (into num_layers mamba stack) after which the *shared*
    # attention block is applied (Zamba2-style: one weight set, many sites).
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper): encoder layers share d_model/heads/d_ff
    encoder_layers: int = 0
    encoder_seq: int = 0        # precomputed frame-embedding length (stub)
    # vlm: number of prefix patch-embedding tokens supplied by the stub
    vision_tokens: int = 0
    # norm/act
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    source: str = ""            # citation

    # ------------------------------------------------------------------
    @property
    def padded_vocab_size(self) -> int:
        """Embedding/LM-head tables are padded to a multiple of 256 so the
        vocab dim always divides the model mesh axis (Megatron-style)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.arch_type == "hybrid"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def num_params(self) -> int:
        """Total parameter count (embedding included)."""
        d, L = self.d_model, self.num_layers
        p = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            p += self.vocab_size * d                  # lm head
        attn = d * self.num_heads * self.head_dim \
            + 2 * d * self.num_kv_heads * self.head_dim \
            + self.num_heads * self.head_dim * d
        ffn_dense = 3 * d * self.d_ff if self.d_ff else 0
        per_layer = 0
        if self.arch_type in ("dense", "vlm"):
            per_layer = attn + ffn_dense + 2 * d
        elif self.arch_type == "moe":
            m = self.moe
            routed = m.num_experts * 3 * d * m.d_expert
            shared = m.num_shared * 3 * d * m.d_expert
            router = d * m.num_experts
            per_layer = attn + routed + shared + router + 2 * d
        elif self.arch_type == "ssm":
            per_layer = self._ssm_params() + d
        elif self.arch_type == "hybrid":
            per_layer = self._ssm_params() + d
            n_sites = L // max(self.hybrid_attn_every, 1)
            # one shared attn+mlp block, counted once
            p += attn + ffn_dense + 2 * d
            del n_sites
        p += per_layer * L
        if self.is_encdec:
            # encoder self-attn+ffn, decoder cross-attn
            p += self.encoder_layers * (attn + ffn_dense + 2 * d)
            p += L * (attn + d)  # cross attention + its norm
        p += d  # final norm
        return p

    def num_active_params(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.arch_type != "moe":
            return self.num_params()
        m = self.moe
        d, L = self.d_model, self.num_layers
        inactive = (m.num_experts - m.top_k) * 3 * d * m.d_expert * L
        return self.num_params() - inactive

    def _ssm_params(self) -> int:
        s, d = self.ssm, self.d_model
        di = s.d_inner(d)
        nh = s.num_heads(d)
        n = s.d_state
        in_proj = d * (2 * di + 2 * n + nh)       # z, x, B, C, dt (B/C: 1 group)
        conv = (s.conv_width + 1) * (di + 2 * n)  # depthwise conv + bias
        out = di * d
        extra = 3 * nh + di                       # A_log, dt_bias, D, norm
        return in_proj + conv + out + extra


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
