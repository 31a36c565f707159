"""CodeQwen1.5-7B — dense MHA decoder [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    source="hf:Qwen/CodeQwen1.5-7B",
)
