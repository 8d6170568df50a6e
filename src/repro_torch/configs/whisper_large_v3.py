"""Whisper-large-v3 backbone (enc-dec; conv/mel frontend stubbed).
[arXiv:2212.04356; unverified] 32+32L d_model=1280 20H (MHA) d_ff=5120
vocab=51866, gelu, decoder max 448 positions."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, head_dim=64, d_ff=5120, vocab_size=51866,
    encoder_decoder=True, n_encoder_layers=32, max_target_positions=448,
    act="gelu", frontend="audio_stub",
)
