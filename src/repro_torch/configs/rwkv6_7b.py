"""RWKV-6 "Finch" 7B — attention-free data-dependent-decay SSM.
[arXiv:2404.05892; hf] 32L d_model=4096 d_ff=14336 vocab=65536, head_dim 64."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, head_dim=64, d_ff=14336, vocab_size=65536,
    ssm_kind="rwkv6", act="relu_sq",
)
