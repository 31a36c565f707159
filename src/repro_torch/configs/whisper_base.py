"""Whisper-base — encoder-decoder transformer backbone [arXiv:2212.04356].

The mel-spectrogram + conv frontend is a stub: ``input_specs`` provides
precomputed frame embeddings (batch, 1500, d_model) consumed by the encoder.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,                # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    encoder_seq=1500,
    rope_theta=0.0,              # whisper uses learned/sinusoidal, we use sinusoid
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
