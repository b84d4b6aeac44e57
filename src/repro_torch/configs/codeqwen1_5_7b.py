"""CodeQwen1.5-7B — qwen1.5-arch, kv=32 (MHA-like), QKV bias [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    qkv_bias=True, activation="swiglu", norm_type="rmsnorm",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="codeqwen-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    qkv_bias=True, activation="swiglu", norm_type="rmsnorm",
)
