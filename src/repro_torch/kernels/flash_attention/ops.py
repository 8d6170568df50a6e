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
    they must be positive and do not change the output, nor the kernel's
    tiling, which is its own: in bf16, prefill runs wgmma on TMA-staged tiles
    of 128 query rows and 64 keys; in f32, the CUDA cores take ``128 / P``
    rows and keys a tile (``P = max(1, D / 32)`` threads a row; at D = 192,
    P = 4 and 16 keys a tile); decode (at
    most 16 query rows) takes a kv head's query rows a block and splits its
    live keys over blocks so that they fill the SMs.
    """
    for name, value in (("block_q", block_q), ("block_k", block_k)):
        if int(value) < 1:
            raise ValueError(f"{name} must be >= 1, got {value}")
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale, kv_len=kv_len)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale, kv_len=kv_len)


__all__ = ["flash_attention"]
