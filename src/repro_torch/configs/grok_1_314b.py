"""Grok-1 (314B) — 8 experts top-2, attention logit softcap 30
[hf:xai-org/grok-1; unverified]."""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    activation="geglu", norm_type="rmsnorm",
    attn_logit_softcap=30.0,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32768),
)

SMOKE = ModelConfig(
    name="grok-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    activation="geglu", norm_type="rmsnorm",
    attn_logit_softcap=30.0,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
)
