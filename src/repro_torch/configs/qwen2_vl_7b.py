"""Qwen2-VL-7B — LM backbone with M-RoPE; vision frontend is a stub that
feeds precomputed patch embeddings [arXiv:2409.12191; hf]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, activation="swiglu", norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision_patch",
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    qkv_bias=True, activation="swiglu", norm_type="rmsnorm",
    mrope_sections=(2, 3, 3),
    frontend="vision_patch",
)
