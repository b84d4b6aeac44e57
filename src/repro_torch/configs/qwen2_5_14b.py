"""Qwen2.5-14B — GQA, QKV bias, 152k vocab [hf:Qwen/Qwen2.5-14B family]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064,
    qkv_bias=True, activation="swiglu", norm_type="rmsnorm",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    qkv_bias=True, activation="swiglu", norm_type="rmsnorm",
)
