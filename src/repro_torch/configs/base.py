"""Config system: model architecture + input-shape grid.

Every assigned architecture is a ``ModelConfig`` (exact published dimensions)
plus a ``reduced()`` counterpart for CPU smoke tests. Input shapes are the
four assigned cells; ``applicable_shapes`` encodes the per-family skips
(long_500k needs sub-quadratic attention; see DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1  # layer i uses MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    moe_d_ff: int = 0  # expert hidden width (0 -> d_ff)
    first_k_dense: int = 0  # leading layers forced dense (deepseek-v2: 1)
    capacity_factor: float = 1.25

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid ---
    ssm_kind: str = ""  # "rwkv6" | "mamba"
    attn_period: int = 0  # jamba: one attn layer per `attn_period` (rest mamba)
    attn_offset: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- encoder-decoder (whisper) ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    max_target_positions: int = 0  # whisper decoder length (448)

    # --- modality frontend stubs ---
    frontend: str = ""  # "audio_stub" | "vision_stub"
    n_prefix_embeds: int = 0  # vlm: patch embeddings prepended to text

    # --- numerics / misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "swiglu"  # "swiglu" | "gelu" | "relu_sq"
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk_q: int = 2048  # chunked-attention tiling for long sequences
    attn_chunk_k: int = 2048
    attn_chunk_threshold: int = 8192  # use chunked path when seq exceeds this

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def uses_full_attention(self) -> bool:
        """True if per-token decode cost is O(seq) (quadratic prefill)."""
        return self.ssm_kind == "" or self.attn_period > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM or hybrid (bounded attention share)."""
        return self.ssm_kind != ""

    def applicable_shapes(self) -> list[str]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.sub_quadratic:
            out.append("long_500k")
        return out

    def moe_at(self, layer: int) -> bool:
        if not self.n_experts:
            return False
        if layer < self.first_k_dense:
            return False
        return layer % self.moe_every == self.moe_offset

    def attn_at(self, layer: int) -> bool:
        """Hybrid archs: which layers are attention (rest SSM)."""
        if not self.attn_period:
            return not self.ssm_kind  # pure attention vs pure ssm
        return layer % self.attn_period == self.attn_offset

    # ------------------------------------------------------------- reduced
    def reduced(self) -> "ModelConfig":
        """Same family/topology, toy width — for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            remat=False,
            param_dtype="float32",
            compute_dtype="float32",
            attn_chunk_threshold=16,  # exercise the chunked path in smoke tests
            attn_chunk_q=16,
            attn_chunk_k=16,
        )
        if self.n_experts:
            kw.update(
                n_experts=4,
                experts_per_token=min(2, self.experts_per_token),
                n_shared_experts=min(1, self.n_shared_experts),
                moe_d_ff=64 if self.moe_d_ff else 0,
                first_k_dense=min(1, self.first_k_dense),
            )
        if self.use_mla:
            kw.update(kv_lora_rank=16, q_lora_rank=32, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16, head_dim=16)
        if self.attn_period:
            kw.update(attn_period=2, attn_offset=self.attn_offset % 2, n_layers=4)
        if self.encoder_decoder:
            kw.update(n_encoder_layers=2, max_target_positions=16)
        if self.n_prefix_embeds:
            kw.update(n_prefix_embeds=8)
        return dataclasses.replace(self, **kw)
