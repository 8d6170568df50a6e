"""Jamba-1.5-Large 398B hybrid: Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887 (+1.5 report); hf] 72L d_model=8192
64H (kv=8) d_ff=24576 vocab=65536. Attention at layer i%8==4."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=65536,
    n_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
    ssm_kind="mamba", attn_period=8, attn_offset=4,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    param_dtype="bfloat16",
)
