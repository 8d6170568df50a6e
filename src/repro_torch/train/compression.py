"""Gradient compression for the cross-pod all-reduce: the port of the
reference's ``train/compression.py``.

int8 block quantisation with stochastic rounding: unbiased (E[deq(q(x))] =
x), so SGD convergence guarantees survive; the bandwidth of the slow
cross-pod axis drops ~4x (bf16 -> int8 + per-block scales). Applied to the
gradient dict *before* the optimizer.

The reference draws its uniforms from ``jax.random``; the port draws them
from an explicit ``torch.Generator``. :func:`quantize_leaf` takes the
uniforms as an argument, so that given the reference's it computes the
reference's values exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def block_shape(numel: int) -> tuple[int, int]:
    """The (blocks, BLOCK) shape of a leaf of ``numel`` values, padded with zeros."""
    return (-(-numel // BLOCK), BLOCK)


def quantize_leaf(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Quantise and dequantise ``g`` block by block; ``u`` (f32 uniforms in
    [0, 1) of :func:`block_shape`) rounds each value up with probability its
    fraction."""
    orig_dtype = g.dtype
    flat = g.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0.0, 1.0, scale)
    x = blocks / scale
    lo = torch.floor(x)
    p_up = x - lo  # stochastic rounding: round up with prob = frac
    q = torch.clamp(lo + (u < p_up), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.reshape(-1)[: g.numel()].reshape(g.shape).to(orig_dtype)


def compress_decompress_int8(grads: dict, generator: torch.Generator) -> dict:
    """Quantise+dequantise every leaf (simulating the compressed all-reduce),
    each leaf's uniforms drawn from ``generator`` (on the leaves' device) in
    the dict's order."""
    return {k: quantize_leaf(g, torch.rand(block_shape(g.numel()), generator=generator, device=g.device))
            for k, g in grads.items()}
