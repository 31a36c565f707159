"""Granite-MoE-3B-A800M — 40 routed experts top-8 [hf:ibm-granite/granite-3.0 family]."""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49155,
    # group_size=64: with top-8 routing and tiny d_expert the dispatch einsum
    # costs g*k*cf*D MACs/token — 64-token groups keep it <15% of expert FLOPs
    # (see EXPERIMENTS.md §Perf, iterations G4-G6).
    moe=MoEConfig(num_experts=40, top_k=8, d_expert=512, num_shared=0,
                  group_size=64),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
