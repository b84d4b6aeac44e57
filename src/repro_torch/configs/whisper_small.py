"""Whisper-small — enc-dec; conv frontend is a stub that feeds precomputed
frame embeddings [arXiv:2212.04356; unverified].

Deviations (DESIGN.md §4): RoPE replaces learned/sinusoidal absolute
positions so the assigned 32k decode shape is well-defined; decoder length
is seq_len // dec_ratio for sequence shapes.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    activation="gelu", norm_type="layernorm",
    is_encoder_decoder=True, num_decoder_layers=12, dec_ratio=4,
    frontend="audio_frames",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    activation="gelu", norm_type="layernorm",
    is_encoder_decoder=True, num_decoder_layers=2, dec_ratio=4,
    frontend="audio_frames",
)
