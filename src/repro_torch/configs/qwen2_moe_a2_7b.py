"""Qwen1.5-MoE-A2.7B — 60 routed experts top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                      # ffn is fully MoE
    vocab_size=151936,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408, num_shared=4),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
