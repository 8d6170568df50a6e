"""Attention blocks: GQA (the dense archs, grok) and MLA (deepseek-v2). The
port of the reference's ``models/attention.py``.

Each block has ``*_specs(cfg)`` (the ParamSpec tree), ``*_apply`` for full
sequences, ``*_prefill`` (also returns the right-padded cache) and
``*_decode`` for one token. Cache layouts per layer:

  GQA: ``{"k": (B, S, KH, D), "v": (B, S, KH, D)}``
  MLA: ``{"ckv": (B, S, kv_lora), "k_rope": (B, S, rope_dim)}`` — the
       compressed latent, not per-head K/V.

The decode functions write the new token's entry into the cache they are
given, in place (the reference returns a new cache; its arrays are
immutable): a caller that keeps a cache for reuse decodes on a copy.
MLA's prefill pads V to the QK head dim (nope + rope, 192 at deepseek-v2's
widths) and runs the shared attention core, the flash kernel on the card;
its decode keeps the reference's weight-absorbed form on the latent cache,
in plain PyTorch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import NEG, ParamSpec, decode_attention, full_attention, rope

# ------------------------------------------------------------------ GQA


def gqa_specs(cfg: ModelConfig, prefix=()) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ax = tuple(prefix)
    return {
        "wq": ParamSpec((d, h, hd), ax + ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kh, hd), ax + ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kh, hd), ax + ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ax + ("heads", "head_dim", "embed")),
    }


def _gqa_project(params, x, cfg, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def _slot(pos: int, cache_len: int) -> int:
    """Where a decode writes: ``pos`` clamped to the cache, as the reference's
    ``dynamic_update_slice`` clamps its start."""
    return min(max(pos, 0), cache_len - 1)


def _pad_len(s: int, cache_len: int) -> int:
    if cache_len < s:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {cache_len}")
    return cache_len - s


def gqa_apply(params, x, cfg: ModelConfig, *, causal=True, positions=None):
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    q, k, v = _gqa_project(params, x, cfg, positions)
    o = full_attention(q, k, v, causal=causal, cfg=cfg)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"])


def gqa_prefill(params, x, cfg: ModelConfig, cache_len: int):
    """Full-sequence pass that also returns a right-padded KV cache."""
    b, s, _ = x.shape
    q, k, v = _gqa_project(params, x, cfg, _positions(b, s, x.device))
    o = full_attention(q, k, v, causal=True, cfg=cfg)
    pad = _pad_len(s, cache_len)
    cache = {"k": F.pad(k, (0, 0, 0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, 0, 0, pad))}
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), cache


def gqa_decode(params, x, cache, pos: int, cfg: ModelConfig):
    """x: (B, 1, d); pos: index of this token. Writes K/V at ``pos`` (clamped
    to the last slot, as the reference's ``dynamic_update_slice`` clamps its
    start) into ``cache`` in place and returns ``(out, cache)``."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _gqa_project(params, x, cfg, positions)
    slot = _slot(pos, cache["k"].shape[1])
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], pos)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), cache


def gqa_cache_spec(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    shp = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_len", "kv_heads", "head_dim")
    return {"k": (shp, axes, dtype), "v": (shp, axes, dtype)}


# ------------------------------------------------------------------ MLA


def mla_specs(cfg: ModelConfig, prefix=()) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    ax = tuple(prefix)
    return {
        "wq_a": ParamSpec((d, r_q), ax + ("embed", "lora")),
        "wq_b": ParamSpec((r_q, h, dn + dr), ax + ("lora", "heads", "head_dim")),
        "wkv_a": ParamSpec((d, r_kv + dr), ax + ("embed", "lora")),
        "wk_b": ParamSpec((r_kv, h, dn), ax + ("lora", "heads", "head_dim")),
        "wv_b": ParamSpec((r_kv, h, dv), ax + ("lora", "heads", "head_dim")),
        "wo": ParamSpec((h, dv, d), ax + ("heads", "head_dim", "embed")),
    }


def _mla_qkv(params, x, cfg: ModelConfig, positions):
    """Returns q (B,S,H,dn+dr), latent ckv (B,S,r_kv), k_rope (B,S,dr)."""
    dn = cfg.nope_head_dim
    q = torch.einsum("bsd,dr->bsr", x, params["wq_a"])
    q = torch.einsum("bsr,rhk->bshk", q, params["wq_b"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv = torch.einsum("bsd,dr->bsr", x, params["wkv_a"])
    ckv, k_rope = kv[..., :cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return torch.cat([q_nope, q_rope], -1), ckv, k_rope


def _mla_expand_kv(params, ckv, k_rope, cfg: ModelConfig):
    """Latent -> per-head K (nope+rope) and V."""
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, params["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", ckv, params["wv_b"])
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], cfg.n_heads, cfg.rope_head_dim)
    return torch.cat([k_nope, k_rope_h], -1), v


def _mla_attention(params, x, cfg: ModelConfig, positions, causal: bool):
    """The shared attention core on the expanded heads, V padded up to the
    QK head dim (dv <= dn + dr holds for deepseek-v2) and sliced back.
    Returns (out (B, S, d), ckv, k_rope)."""
    q, ckv, k_rope = _mla_qkv(params, x, cfg, positions)
    k, v = _mla_expand_kv(params, ckv, k_rope, cfg)
    dqk = cfg.nope_head_dim + cfg.rope_head_dim
    vpad = F.pad(v, (0, dqk - cfg.v_head_dim))
    o = full_attention(q, k, vpad, causal=causal, cfg=cfg)[..., :cfg.v_head_dim]
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), ckv, k_rope


def mla_apply(params, x, cfg: ModelConfig, *, causal=True, positions=None):
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    return _mla_attention(params, x, cfg, positions, causal)[0]


def mla_prefill(params, x, cfg: ModelConfig, cache_len: int):
    """Full-sequence pass that also returns the right-padded latent cache."""
    b, s, _ = x.shape
    pad = _pad_len(s, cache_len)
    out, ckv, k_rope = _mla_attention(params, x, cfg, _positions(b, s, x.device), True)
    return out, {"ckv": F.pad(ckv, (0, 0, 0, pad)), "k_rope": F.pad(k_rope, (0, 0, 0, pad))}


def mla_decode(params, x, cache, pos: int, cfg: ModelConfig):
    """x: (B, 1, d); pos: index of this token. Writes the latent and k_rope
    at ``pos`` (clamped to the last slot) into ``cache`` in place and returns
    ``(out, cache)``.

    Weight-absorbed MLA decode (DeepSeek-V2's inference path): the scores are
    taken directly on the latent cache, ``(wk_b^T q_nope) . c_t + q_rope .
    k_rope_t``, and the output is the latent's weighted sum through ``wv_b``;
    per-head K/V are never built. The products the reference takes with f32
    output run on f32 operands here (a product of two bf16 values is exact
    in f32), so the port rounds where the reference does."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, ckv, k_rope = _mla_qkv(params, x, cfg, positions)
    ckv_c, kr_c = cache["ckv"], cache["k_rope"]
    slot = _slot(pos, ckv_c.shape[1])
    ckv_c[:, slot] = ckv[:, 0].to(ckv_c.dtype)
    kr_c[:, slot] = k_rope[:, 0].to(kr_c.dtype)
    q_nope, q_rope = q[..., :cfg.nope_head_dim], q[..., cfg.nope_head_dim:]
    q_eff = torch.einsum("bshn,rhn->bshr", q_nope, params["wk_b"])
    s_lat = torch.einsum("bshr,btr->bhst", q_eff.float(), ckv_c.float())
    s_rope = torch.einsum("bshk,btk->bhst", q_rope.float(), kr_c.float())
    scores = (s_lat + s_rope) / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    mask = torch.arange(scores.shape[-1], device=x.device)[None, None, None, :] <= pos
    p = torch.softmax(torch.where(mask, scores, NEG), dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", p.to(ckv_c.dtype).float(), ckv_c.float())
    o = torch.einsum("bshr,rhv->bshv", o_lat.to(x.dtype), params["wv_b"])
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), cache


def mla_cache_spec(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    return {
        "ckv": ((batch, cache_len, cfg.kv_lora_rank), ("batch", "kv_len", "lora"), dtype),
        "k_rope": ((batch, cache_len, cfg.rope_head_dim), ("batch", "kv_len", "head_dim"), dtype),
    }
