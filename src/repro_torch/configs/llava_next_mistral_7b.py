"""LLaVA-NeXT (mistral-7b backbone), anyres vision frontend stubbed as 1152
precomputed patch embeddings prepended to the text sequence.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=32000,
    rope_theta=1_000_000.0, frontend="vision_stub", n_prefix_embeds=1152,
)
