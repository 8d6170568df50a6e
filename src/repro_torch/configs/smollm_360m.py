"""SmolLM 360M llama-arch small. [hf:HuggingFaceTB/SmolLM-360M; hf]
32L d_model=960 15H (kv=5) d_ff=2560 vocab=49152. Note 15 heads / d_ff 2560
are not 128-multiples: sharding rules fall back per-axis (DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense", n_layers=32, d_model=960,
    n_heads=15, n_kv_heads=5, head_dim=64, d_ff=2560, vocab_size=49152,
)
