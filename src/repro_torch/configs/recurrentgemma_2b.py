"""RecurrentGemma-2B — Griffin: RG-LRU + local attention, 1 attn per 2
recurrent blocks [arXiv:2402.19427; hf]."""
from repro_torch.config import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000,
    activation="geglu", norm_type="rmsnorm", tie_embeddings=True,
    recurrent=RecurrentConfig(
        lru_width=2560, conv1d_width=4,
        block_pattern=("recurrent", "recurrent", "attention"),
        window_size=2048,
    ),
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512,
    activation="geglu", norm_type="rmsnorm", tie_embeddings=True,
    recurrent=RecurrentConfig(
        lru_width=64, conv1d_width=4,
        block_pattern=("recurrent", "recurrent", "attention"),
        window_size=8,
    ),
)
