"""RWKV-6 (Finch) 3B — attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""
from repro_torch.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    activation="relu_sq", norm_type="layernorm",
    rwkv=RWKVConfig(head_size=64, decay_lora=64, gate_lora=160),
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    activation="relu_sq", norm_type="layernorm",
    rwkv=RWKVConfig(head_size=16, decay_lora=8, gate_lora=16),
)
