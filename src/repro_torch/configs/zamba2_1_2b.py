"""Zamba2-1.2B — hybrid Mamba2 stack + shared attention block [arXiv:2411.15242]."""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,                # 32 heads * 64 = 2048 for the shared block
    d_ff=8192,                  # shared block MLP
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4),
    hybrid_attn_every=6,        # shared attn+mlp applied after every 6 mamba layers
    source="arXiv:2411.15242",
)
