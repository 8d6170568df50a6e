"""Attention block: GQA (the dense archs). The port of the GQA half of the
reference's ``models/attention.py``; MLA waits (ROADMAP module 12).

``gqa_specs(cfg)`` (the ParamSpec tree), ``gqa_apply`` for full sequences,
``gqa_prefill`` (also returns the right-padded KV cache) and ``gqa_decode``
for one token. Cache layout per layer: ``{"k": (B, S, KH, D), "v": (B, S,
KH, D)}``.

``gqa_decode`` writes the new token's K/V into the cache it is given, in
place (the reference returns a new cache; its arrays are immutable): a caller
that keeps a cache for reuse decodes on a copy.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, decode_attention, full_attention, rope


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
    pad = cache_len - s
    if pad < 0:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {cache_len}")
    cache = {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
             "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), cache


def gqa_decode(params, x, cache, pos: int, cfg: ModelConfig):
    """x: (B, 1, d); pos: index of this token. Writes K/V at ``pos`` (clamped
    to the last slot, as the reference's ``dynamic_update_slice`` clamps its
    start) into ``cache`` in place and returns ``(out, cache)``."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _gqa_project(params, x, cfg, positions)
    slot = min(max(pos, 0), cache["k"].shape[1] - 1)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], pos)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), cache


def gqa_cache_spec(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    shp = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_len", "kv_heads", "head_dim")
    return {"k": (shp, axes, dtype), "v": (shp, axes, dtype)}
