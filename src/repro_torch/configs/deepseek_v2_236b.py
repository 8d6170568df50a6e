"""DeepSeek-V2 236B: MLA + 160 routed experts top-6 + 2 shared.
[arXiv:2405.04434; hf] 60L d_model=5120 128H, kv_lora=512 q_lora=1536,
nope/rope/v head dims 128/64/128, expert d_ff=1536, first layer dense
(d_ff 12288), vocab=102400."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, head_dim=192, d_ff=12288, vocab_size=102400,
    n_experts=160, experts_per_token=6, n_shared_experts=2, moe_d_ff=1536,
    first_k_dense=1, use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    nope_head_dim=128, rope_head_dim=64, v_head_dim=128,
    param_dtype="bfloat16",
)
