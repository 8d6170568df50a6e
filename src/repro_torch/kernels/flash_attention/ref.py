"""Plain PyTorch oracle: naive (materialised-scores) attention with GQA.

A line-for-line mirror of the reference's ``kernels/flash_attention/ref.py``:
f32 scores, the finite ``-1e30`` mask, ``l == 0 -> 1``, the result cast to
``q.dtype``. It is the plain version of the flash kernel: the CPU path of
``ops.flash_attention``, and what the kernel is held to on the card.
"""
from __future__ import annotations

import math

import torch


def naive_attention(q, k, v, *, causal=True, scale=None, kv_len=None, q_offset=0):
    """(B, H, Sq, D) x (B, KH, Skv, D) -> (B, H, Sq, D), f32 softmax.
    ``q_offset`` (not in the reference) is the first query row's index, so
    that a caller can take the rows in chunks."""
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    group = h // kh
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kv_len = skv if kv_len is None else kv_len

    kq = torch.repeat_interleave(k, group, dim=1).float()
    vq = torch.repeat_interleave(v, group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    col = torch.arange(skv, device=q.device)[None, None, None, :]
    mask = col < kv_len
    if causal:
        row = q_offset + torch.arange(sq, device=q.device)[None, None, :, None]
        mask = mask & (col <= row)
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vq) / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.to(q.dtype)
