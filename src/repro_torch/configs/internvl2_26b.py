"""InternVL2-26B — InternViT (stubbed) + InternLM2 LM backbone [arXiv:2404.16821].

The vision encoder + MLP projector are a stub per the brief: ``input_specs``
supplies precomputed patch embeddings of shape (batch, vision_tokens, d_model)
which the decoder interleaves before the text tokens.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    arch_type="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    vision_tokens=256,           # one 448px tile -> 256 projected patch tokens
    source="arXiv:2404.16821",
)
