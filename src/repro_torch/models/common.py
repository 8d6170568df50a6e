"""Shared model machinery: parameter specs, norms, RoPE, MLPs, and attention.

The port of the reference's ``models/common.py`` (what the dense and MoE
models use).
Layouts are the reference's: activations ``(B, S, d)``, heads ``(B, S, H, D)``.
The plain attention functions mirror the reference's jnp code, rounding bf16
at the same points (``p`` is cast to V's type before the PV product); they
are the CPU path. On a CUDA tensor, :func:`full_attention` and
:func:`decode_attention` call the hand-written flash kernel
(``kernels.flash_attention.ops.flash_attention``) instead, which keeps ``p``
in f32: the reference calls the Pallas flash kernel the TPU-native version of
this same function. The kernel has no backward, so a forward that autograd
records (:func:`records`: training) takes the plain functions on the card
too, as the reference trains through them. :func:`remat` is the reference's
``jax.checkpoint`` around a layer. There is no sharding here (``shard_hint``
waits for the port's sharding module).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from repro_torch.kernels.flash_attention import ops as flash_ops

NEG = -1e30  # the reference's finite mask value


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def records(*trees) -> bool:
    """Whether autograd records an op on these tensors (or on the tensors in
    these nested dicts, lists and tuples): grad is enabled and one of them
    requires grad. Serving (``torch.no_grad``) never records."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(trees))


def recomputed(fn, *args, **kw):
    """``fn(*args, **kw)`` under ``torch.utils.checkpoint`` (non-reentrant;
    nothing random inside, so no RNG state is kept): the backward pass keeps
    only its inputs and runs it again, as ``jax.checkpoint`` does."""
    return checkpoint.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def remat(cfg, fn, *args, **kw):
    """``fn(*args, **kw)``, :func:`recomputed` where ``cfg.remat`` is set and
    autograd records: the reference's ``jax.checkpoint`` around each block.
    A plain call otherwise, as in every served forward."""
    if cfg.remat and records(args, kw):
        return recomputed(fn, *args, **kw)
    return fn(*args, **kw)


# ----------------------------------------------------------------- params


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]  # e.g. ("layers", "embed", "mlp")
    init: str = "normal"  # normal | zeros | ones | small
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.logical_axes), (self.shape, self.logical_axes)


SpecTree = dict[str, Any]  # nested dict of ParamSpec


def flatten_specs(specs: SpecTree, prefix: str = "") -> dict[str, ParamSpec]:
    """``{"a.b.c": ParamSpec}`` for a nested spec tree."""
    out = {}
    for key, value in specs.items():
        name = f"{prefix}{key}"
        if isinstance(value, ParamSpec):
            out[name] = value
        else:
            out.update(flatten_specs(value, name + "."))
    return out


def count_params(specs: SpecTree) -> int:
    return int(sum(np.prod(s.shape) for s in flatten_specs(specs).values()))


def init_param(param: torch.Tensor, spec: ParamSpec, generator: torch.Generator) -> None:
    """Fill one parameter as the reference's ``init_params`` does: zeros, ones,
    or normal draws times ``spec.scale`` (``small``: times 1e-3), drawn in f32
    from ``generator`` (on the parameter's device) in place: ``normal_`` rounds
    the draw times the scale once to the parameter's dtype, with no f32 copy
    of it (jamba's expert tensors hold 3.2 G values)."""
    with torch.no_grad():
        if spec.init == "zeros":
            param.zero_()
        elif spec.init == "ones":
            param.fill_(1.0)
        else:
            scale = spec.scale if spec.init == "normal" else 1e-3
            param.normal_(0.0, scale, generator=generator)


# ----------------------------------------------------------------- layers


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D_even), positions: (..., S). A bf16
    ``x`` meets the f32 angles and is promoted to f32 before the cast back,
    as in the reference."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions[..., :, None, None].float() * inv  # (..., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def activation(name: str, gate: torch.Tensor, up: torch.Tensor | None = None) -> torch.Tensor:
    if name == "swiglu":
        assert up is not None
        return F.silu(gate) * up
    if name == "gelu":
        return F.gelu(gate, approximate="tanh")  # jax.nn.gelu's default
    if name == "relu_sq":
        return torch.square(F.relu(gate))
    raise ValueError(name)


def mlp_specs(d_model: int, d_ff: int, act: str, prefix_axes=()) -> SpecTree:
    ax = tuple(prefix_axes)

    def sp(shape, axes):
        return ParamSpec(tuple(shape), ax + tuple(axes))

    if act == "swiglu":
        return {
            "w_gate": sp((d_model, d_ff), ("embed", "mlp")),
            "w_up": sp((d_model, d_ff), ("embed", "mlp")),
            "w_down": sp((d_ff, d_model), ("mlp", "embed")),
        }
    return {
        "w_in": sp((d_model, d_ff), ("embed", "mlp")),
        "w_out": sp((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_apply(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        return activation("swiglu", x @ params["w_gate"], x @ params["w_up"]) @ params["w_down"]
    return activation(act, x @ params["w_in"]) @ params["w_out"]


# ------------------------------------------------------- plain attention
#
# The reference's chunked path (its XLA path for long context, and the oracle
# its flash kernel is validated against) and its dense path, mirrored; the
# card's served forward runs the flash kernel for both, its training forward
# these.


def _online_attn_block(q, k, v, mask, scale):
    """One (cq x ck) block, grouped GQA form: q (B,cq,KH,G,D), k/v (B,ck,KH,D).
    Returns (max (B,KH,G,cq), sum, acc (B,cq,KH,G,D))."""
    s = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) * scale
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), v.float())
    return m, l, acc


def chunked_attention(q, k, v, *, causal: bool, chunk_q: int, chunk_k: int, scale: float | None = None,
                      q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, KH, D): online softmax over key chunks,
    one query chunk at a time; causal query chunks compute only the key chunks
    at or below their last row."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    group = h // kh
    qg = q.reshape(b, sq, kh, group, d)
    scale = 1.0 / math.sqrt(d) if scale is None else scale

    cq = min(chunk_q, sq)
    ck = min(chunk_k, skv)
    assert sq % cq == 0 and skv % ck == 0, (sq, cq, skv, ck)
    nq, nk = sq // cq, skv // ck
    dev = q.device

    out_chunks = []
    for i in range(nq):
        qi = qg[:, i * cq:(i + 1) * cq]
        row = q_offset + i * cq + torch.arange(cq, device=dev)
        # causal: keys beyond this q-chunk's last row can never contribute
        hi = min(nk, (q_offset + (i + 1) * cq + ck - 1) // ck) if causal else nk
        m_run = torch.full((b, kh, group, cq), NEG, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, kh, group, cq), dtype=torch.float32, device=dev)
        acc_run = torch.zeros((b, cq, kh, group, d), dtype=torch.float32, device=dev)
        for j in range(hi):
            kj, vj = k[:, j * ck:(j + 1) * ck], v[:, j * ck:(j + 1) * ck]
            col = j * ck + torch.arange(ck, device=dev)
            if causal:
                mask = col[None, None, None, None, :] <= row[None, None, None, :, None]
            else:
                mask = torch.ones((1, 1, 1, 1, ck), dtype=torch.bool, device=dev)
            m, l, acc = _online_attn_block(qi, kj, vj, mask, scale)
            m_new = torch.maximum(m_run, m)
            a_old = torch.exp(m_run - m_new)
            a_new = torch.exp(m - m_new)
            l_run = l_run * a_old + l * a_new
            acc_run = acc_run * a_old.permute(0, 3, 1, 2)[..., None] + acc * a_new.permute(0, 3, 1, 2)[..., None]
            m_run = m_new
        l_f = torch.where(l_run == 0.0, 1.0, l_run)
        o = acc_run / l_f.permute(0, 3, 1, 2)[..., None]
        out_chunks.append(o.reshape(b, cq, h, d).to(q.dtype))
    return torch.cat(out_chunks, dim=1)


def naive_causal_attention(q, k, v, *, causal=True, scale=None, q_offset=0) -> torch.Tensor:
    """Plain masked attention for short sequences (single materialised score)."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    group = h // kh
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        row = q_offset + torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(col <= row, s, NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _flash(q, k, v, **kw) -> torch.Tensor:
    """The flash kernel on the model's (B, S, heads, D) tensors, as transposed
    views in and out (no copy)."""
    return flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)


def full_attention(q, k, v, *, causal, cfg, q_offset=0) -> torch.Tensor:
    """The flash kernel on the card; on the CPU, and wherever autograd
    records (training: the kernel has no backward, and the reference trains
    through its XLA path), the reference's dispatch: the chunked path beyond
    the threshold, the dense one below it."""
    if q.is_cuda and not records(q, k, v):
        if q_offset:
            raise ValueError("the flash kernel takes top-left aligned rows only (q_offset = 0)")
        return _flash(q, k, v, causal=causal)
    if q.shape[1] > cfg.attn_chunk_threshold:
        return chunked_attention(q, k, v, causal=causal, chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k,
                                 q_offset=q_offset)
    return naive_causal_attention(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, pos: int) -> torch.Tensor:
    """Single-token attention against a (possibly longer) KV cache.

    q: (B, 1, H, D); caches: (B, S, KH, D); pos: the current position. Keys
    at or below ``pos`` are live: on the card the kernel runs non-causal with
    ``kv_len = pos + 1`` (every column once ``pos >= S``)."""
    s = k_cache.shape[1]
    if q.is_cuda:
        return _flash(q, k_cache, v_cache, causal=False, kv_len=min(pos + 1, s))
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    group = h // kh
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, kh, group, d)
    s_logits = torch.einsum("bkgd,bskd->bkgs", qf.float(), k_cache.float()) * scale
    mask = torch.arange(s, device=q.device)[None, None, None, :] <= pos
    s_logits = torch.where(mask, s_logits, NEG)
    p = torch.softmax(s_logits, dim=-1).to(v_cache.dtype)  # stay in cache dtype
    out = torch.einsum("bkgs,bskd->bkgd", p.float(), v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
