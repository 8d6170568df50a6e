"""Grok-1 314B MoE: 8 experts top-2. [hf:xai-org/grok-1; unverified]
64L d_model=6144 48H (kv=8) d_ff=32768 vocab=131072. E=8 < model axis 16,
so experts replicate across EP groups with TP inside experts (DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=32768, vocab_size=131072,
    n_experts=8, experts_per_token=2, param_dtype="bfloat16",
)
