"""Whisper-style encoder-decoder backbone (audio frontend stubbed): the port of
the reference's ``models/whisper.py``.

``enc_embeds`` (B, S_frames, d_model) arrive precomputed (the conv/mel
frontend is a stub). The encoder is a non-causal attention stack; the decoder
interleaves causal self-attention, cross-attention into the encoder output and
a dense FFN. The decoder's length is bounded by ``max_target_positions``
(448); RoPE replaces Whisper's learned positions, as in the reference.

The reference scans stacked layers; here each layer is a ``ParamTree`` under
``encoder.<i>`` and ``decoder.<i>`` (:func:`port_specs`) and a Python loop
walks them. Every function takes the parameters as the nested dict of
``Model.params()`` (``encoder`` and ``decoder`` lists of layer dicts) in the
compute dtype. The decode cache is ``{"self_k", "self_v": (L, B,
max_target_positions, KH, D), "cross_k", "cross_v": (L, B, S_src, KH, D)}``:
prefill computes each layer's cross K/V once from the encoder output and
stores them, decode reads them and writes its self K/V in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    ParamSpec,
    decode_attention,
    flatten_specs,
    full_attention,
    mlp_apply,
    mlp_specs,
    remat,
    rms_norm,
)
from repro_torch.models.transformer import stacked


def _cross_specs(cfg: ModelConfig) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }


def _cross_kv(p, enc_out):
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    return k, v


def _cross_apply(p, x, k, v, cfg):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    o = full_attention(q, k, v, causal=False, cfg=cfg)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _cross_decode(p, x, k, v):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    o = decode_attention(q, k, v, k.shape[1] - 1)  # the whole source is visible
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _enc_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn.gqa_specs(cfg),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ffn": mlp_specs(cfg.d_model, cfg.d_ff, cfg.act),
    }


def _dec_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "self": attn.gqa_specs(cfg),
        "ln_x": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "cross": _cross_specs(cfg),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ffn": mlp_specs(cfg.d_model, cfg.d_ff, cfg.act),
    }


def whisper_specs(cfg: ModelConfig) -> dict:
    """The reference's spec tree: the layers stacked on a leading ``layers`` axis."""
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "encoder": stacked(_enc_layer_specs(cfg), cfg.n_encoder_layers),
        "enc_ln_f": ParamSpec((d,), ("embed",), init="ones"),
        "decoder": stacked(_dec_layer_specs(cfg), cfg.n_layers),
        "embed": ParamSpec((v, d), ("vocab", "embed")),
        "ln_f": ParamSpec((d,), ("embed",), init="ones"),
        "unembed": ParamSpec((d, v), ("embed", "vocab")),
    }


def port_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """``{parameter name: ParamSpec}`` in the port's layout (``encoder.<i>.*``,
    ``decoder.<i>.*``, the layers axis taken off)."""
    d, v = cfg.d_model, cfg.vocab_size
    specs = {"embed": ParamSpec((v, d), ("vocab", "embed"))}
    for stack, n, layer in (("encoder", cfg.n_encoder_layers, _enc_layer_specs(cfg)),
                            ("decoder", cfg.n_layers, _dec_layer_specs(cfg))):
        flat = flatten_specs(layer)
        for i in range(n):
            specs.update({f"{stack}.{i}.{k}": s for k, s in flat.items()})
    specs["enc_ln_f"] = ParamSpec((d,), ("embed",), init="ones")
    specs["ln_f"] = ParamSpec((d,), ("embed",), init="ones")
    specs["unembed"] = ParamSpec((d, v), ("embed", "vocab"))
    return specs


def _add_norm(cfg, x, a, gamma):
    """``(x + a, rms_norm(x + a))``: the residual in the compute dtype, and the
    next sublayer's input, normed from the sum before its bf16 rounding as
    the reference's fused XLA computation does (``transformer.ffn_input``)."""
    return x + a, rms_norm(x.float() + a.float(), gamma, cfg.norm_eps).to(x.dtype)


def _enc_layer(cfg, p, h):
    a = attn.gqa_apply(p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), cfg, causal=False)
    h, n = _add_norm(cfg, h, a, p["ln2"])
    return h + mlp_apply(p["ffn"], n, cfg.act)


def encode(cfg: ModelConfig, params, enc_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder over ``enc_embeds`` (in the compute dtype): non-causal
    self-attention, each layer rematerialised in a recorded forward where
    ``cfg.remat`` is set (as the reference checkpoints its scanned layer)."""
    h = enc_embeds
    for p in params["encoder"]:
        h = remat(cfg, _enc_layer, cfg, p, h)
    return rms_norm(h, params["enc_ln_f"], cfg.norm_eps)


def _dec_layer(cfg, p, h, enc_out):
    a = attn.gqa_apply(p["self"], rms_norm(h, p["ln1"], cfg.norm_eps), cfg)
    h, n = _add_norm(cfg, h, a, p["ln_x"])
    k, v = _cross_kv(p["cross"], enc_out)
    h, n = _add_norm(cfg, h, _cross_apply(p["cross"], n, k, v, cfg), p["ln2"])
    return h + mlp_apply(p["ffn"], n, cfg.act)


def hidden(cfg: ModelConfig, params, enc_embeds: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``enc_embeds`` (B, S_src, d) in the compute dtype, ``tokens`` (B, S_tgt)
    int64 -> the decoder's final normed hidden states (B, S_tgt, d)."""
    enc_out = encode(cfg, params, enc_embeds)
    x = params["embed"][tokens]
    for p in params["decoder"]:
        x = remat(cfg, _dec_layer, cfg, p, x, enc_out)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def apply(cfg: ModelConfig, params, enc_embeds: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return (hidden(cfg, params, enc_embeds, tokens) @ params["unembed"]).float()


def cache_spec(cfg: ModelConfig, batch: int, src_len: int, dtype):
    """The decode cache's ``{name: (shape, logical_axes, dtype)}``: the self
    cache is ``max_target_positions`` long whatever the caller's length, the
    cross cache ``src_len``."""
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    tgt = cfg.max_target_positions
    L = cfg.n_layers
    self_axes = ("layers", "batch", None, "kv_heads", "head_dim")
    cross_axes = ("layers", "batch", "kv_len", "kv_heads", "head_dim")
    return {
        "self_k": ((L, batch, tgt, kh, hd), self_axes, dtype),
        "self_v": ((L, batch, tgt, kh, hd), self_axes, dtype),
        "cross_k": ((L, batch, src_len, kh, hd), cross_axes, dtype),
        "cross_v": ((L, batch, src_len, kh, hd), cross_axes, dtype),
    }


def prefill_encoded(cfg: ModelConfig, params, enc_out: torch.Tensor, tokens: torch.Tensor):
    """The decoder prompt over an encoder output: returns (logits (B, S, V)
    f32, cache), each layer's cross K/V computed once here and stored."""
    x = params["embed"][tokens]
    caches = []
    for p in params["decoder"]:
        a, kv = attn.gqa_prefill(p["self"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, cfg.max_target_positions)
        x, n = _add_norm(cfg, x, a, p["ln_x"])
        ck, cv = _cross_kv(p["cross"], enc_out)
        x, n = _add_norm(cfg, x, _cross_apply(p["cross"], n, ck, cv, cfg), p["ln2"])
        x = x + mlp_apply(p["ffn"], n, cfg.act)
        caches.append({"self_k": kv["k"], "self_v": kv["v"], "cross_k": ck, "cross_v": cv})
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    cache = {name: torch.stack([c[name] for c in caches]) for name in caches[0]}
    return (x @ params["unembed"]).float(), cache


def prefill(cfg: ModelConfig, params, enc_embeds: torch.Tensor, tokens: torch.Tensor):
    """Encode the source and run the decoder prompt; returns (logits, cache)."""
    return prefill_encoded(cfg, params, encode(cfg, params, enc_embeds), tokens)


def decode_step(cfg: ModelConfig, params, cache: dict, tokens: torch.Tensor, pos: int):
    """tokens: (B, 1) decoder token at position ``pos``. Writes the self K/V
    at ``pos`` into ``cache`` in place, reads the stored cross K/V; returns
    (logits (B, V) f32, cache)."""
    x = params["embed"][tokens]
    for i, p in enumerate(params["decoder"]):
        a, _ = attn.gqa_decode(p["self"], rms_norm(x, p["ln1"], cfg.norm_eps),
                               {"k": cache["self_k"][i], "v": cache["self_v"][i]}, pos, cfg)
        x, n = _add_norm(cfg, x, a, p["ln_x"])
        x, n = _add_norm(cfg, x, _cross_decode(p["cross"], n, cache["cross_k"][i], cache["cross_v"][i]), p["ln2"])
        x = x + mlp_apply(p["ffn"], n, cfg.act)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (x[:, -1, :] @ params["unembed"]).float(), cache
