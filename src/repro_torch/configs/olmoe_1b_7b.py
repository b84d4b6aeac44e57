"""OLMoE-1B-7B — 64 experts, top-8 [arXiv:2409.02060; hf]."""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    activation="swiglu", norm_type="rmsnorm",
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
)

SMOKE = ModelConfig(
    name="olmoe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=64, vocab_size=512,
    activation="swiglu", norm_type="rmsnorm",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
)
