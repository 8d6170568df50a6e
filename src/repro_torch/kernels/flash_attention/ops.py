"""Public entry point of the flash-attention kernel."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda, flash_attention_plain


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None, kv_len: int | None = None,
                    block_q: int = 128, block_k: int = 128):
    """Attention of q ``(B, H, Sq, D)`` over k/v ``(B, KH, Skv, D)`` with GQA;
    returns ``(B, H, Sq, D)`` in ``q.dtype``. The reference's signature
    without ``interpret``; see :mod:`repro_torch.kernels.flash_attention.flash_attention`
    for the contract.

    CUDA tensors launch the kernel; CPU tensors run the plain version. There is
    no other path. ``block_q`` and ``block_k`` are the reference's tile sizes:
    they must be positive and do not change the output; the kernel's tiles
    follow the head dim (``128 / P`` query rows and ``128 / P`` keys a tile,
    ``P = max(1, D / 32)`` threads a row), so they do not change its tiling
    either.
    """
    for name, value in (("block_q", block_q), ("block_k", block_k)):
        if int(value) < 1:
            raise ValueError(f"{name} must be >= 1, got {value}")
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale, kv_len=kv_len)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale, kv_len=kv_len)


__all__ = ["flash_attention"]
