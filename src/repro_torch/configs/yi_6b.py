"""Yi-6B — llama-arch GQA [arXiv:2403.04652; hf]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    activation="swiglu", norm_type="rmsnorm", rope_theta=5_000_000.0,
)

SMOKE = ModelConfig(
    name="yi-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab_size=512,
    activation="swiglu", norm_type="rmsnorm",
)
