"""Decoder stack for the dense GQA archs: the port of the reference's
``models/transformer.py`` (``layer_descs``, ``stack_pattern`` and the dense
GQA sublayer).

The reference scans stacked blocks with ``lax.scan``; here the stack is an
``nn.ModuleList`` of :class:`Sublayer`, one a layer, walked by a Python loop.
The decode cache is stacked as in the reference's ``stack.blocks.0`` leaves:
``{"k": (L, B, S, KH, D), "v": (L, B, S, KH, D)}``, layer ``i`` reading and
writing its slice. MoE, MLA, RWKV and Mamba layers wait (ROADMAP module 12).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import ParamSpec, flatten_specs, mlp_apply, mlp_specs, rms_norm


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str  # "gqa" | "mla" | "rwkv6" | "mamba"
    ffn: str  # "dense" | "moe" | "cmix"


def layer_descs(cfg: ModelConfig) -> list[LayerDesc]:
    out = []
    for i in range(cfg.n_layers):
        if cfg.ssm_kind == "rwkv6":
            mixer = "rwkv6"
        elif cfg.ssm_kind == "mamba":
            mixer = "gqa" if cfg.attn_at(i) else "mamba"
        elif cfg.use_mla:
            mixer = "mla"
        else:
            mixer = "gqa"
        if cfg.ssm_kind == "rwkv6":
            ffn = "cmix"
        else:
            ffn = "moe" if cfg.moe_at(i) else "dense"
        out.append(LayerDesc(mixer, ffn))
    return out


def stack_pattern(cfg: ModelConfig):
    """Returns (prefix_descs, pattern_descs, n_blocks): prefix layers are
    unrolled; the remaining layers are `n_blocks` repeats of the pattern."""
    descs = layer_descs(cfg)
    prefix = descs[: cfg.first_k_dense]
    rest = descs[cfg.first_k_dense:]
    plen = len(rest)
    for cand in range(1, len(rest) + 1):
        if len(rest) % cand == 0 and all(rest[i] == rest[i % cand] for i in range(len(rest))):
            plen = cand
            break
    return prefix, rest[:plen], len(rest) // plen


DENSE_GQA = LayerDesc("gqa", "dense")


def _require_dense_gqa(desc: LayerDesc) -> None:
    if desc != DENSE_GQA:
        raise NotImplementedError(
            f"layer {desc} is not ported: the port runs dense GQA layers only (ROADMAP module 12)")


# --------------------------------------------------------------- sublayer


def sublayer_specs(cfg: ModelConfig, desc: LayerDesc) -> dict:
    _require_dense_gqa(desc)
    return {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mixer": attn.gqa_specs(cfg),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ffn": mlp_specs(cfg.d_model, cfg.d_ff, cfg.act),
    }


def sublayer_apply(cfg, desc, p, x, *, causal=True):
    _require_dense_gqa(desc)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.gqa_apply(p["mixer"], h, cfg, causal=causal)
    return x + mlp_apply(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act)


def sublayer_prefill(cfg, desc, p, x, cache_len):
    """Full-sequence pass that also emits this layer's decode cache."""
    _require_dense_gqa(desc)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mix, cache = attn.gqa_prefill(p["mixer"], h, cfg, cache_len)
    x = x + mix
    return x + mlp_apply(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act), cache


def sublayer_decode(cfg, desc, p, x, cache, pos):
    """One token; updates ``cache`` (this layer's K/V views) in place."""
    _require_dense_gqa(desc)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mix, cache = attn.gqa_decode(p["mixer"], h, cache, pos, cfg)
    x = x + mix
    return x + mlp_apply(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act), cache


def sublayer_cache_spec(cfg, desc, batch, cache_len, dtype):
    """(shape, logical_axes, dtype) tree for this sublayer's decode cache."""
    _require_dense_gqa(desc)
    return attn.gqa_cache_spec(cfg, batch, cache_len, dtype)


class Sublayer(nn.Module):
    """One layer's parameters (``ln1``, ``mixer``, ``ln2``, ``ffn``), named as
    the reference's tree under ``stack.blocks.<j>`` without the layers axis."""

    def __init__(self, cfg: ModelConfig, desc: LayerDesc, dtype: torch.dtype, device):
        super().__init__()
        self.desc = desc
        for name, value in sublayer_specs(cfg, desc).items():
            if isinstance(value, ParamSpec):
                setattr(self, name, _param(value, dtype, device))
            else:
                setattr(self, name, nn.ParameterDict(
                    {k: _param(s, dtype, device) for k, s in flatten_specs(value).items()}))

    def tree(self, dtype: torch.dtype) -> dict:
        """The layer's parameters as the reference's nested dict, cast to
        ``dtype`` (no copy where they already have it)."""
        out = {}
        for name, child in (("ln1", self.ln1), ("mixer", self.mixer), ("ln2", self.ln2), ("ffn", self.ffn)):
            if isinstance(child, nn.ParameterDict):
                out[name] = {k: p.detach().to(dtype) for k, p in child.items()}
            else:
                out[name] = child.detach().to(dtype)
        return out


def _param(spec: ParamSpec, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(spec.shape, dtype=dtype, device=device), requires_grad=False)


# ------------------------------------------------------------------ stack


def stack_specs(cfg: ModelConfig) -> dict:
    """The reference's layout: the pattern's sublayers stacked on a leading
    ``layers`` axis (``stack.blocks.<j>``), prefix layers unstacked."""
    prefix, pattern, n_blocks = stack_pattern(cfg)
    specs: dict = {}
    if prefix:
        specs["prefix"] = {str(i): sublayer_specs(cfg, d) for i, d in enumerate(prefix)}

    def stacked(tree):
        return {k: ParamSpec((n_blocks,) + s.shape, ("layers",) + s.logical_axes, s.init, s.scale)
                if isinstance(s, ParamSpec) else stacked(s) for k, s in tree.items()}

    specs["blocks"] = stacked({str(j): sublayer_specs(cfg, d) for j, d in enumerate(pattern)})
    return specs


def stack_apply(cfg: ModelConfig, layers: list[dict], descs, x, *, causal=True):
    for desc, p in zip(descs, layers):
        x = sublayer_apply(cfg, desc, p, x, causal=causal)
    return x


def stack_cache_spec(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    """``{"k": ((L, B, S, KH, D), axes, dtype), "v": ...}``."""
    spec = {}
    for desc in set(layer_descs(cfg)):
        for name, (shape, axes, dt) in sublayer_cache_spec(cfg, desc, batch, cache_len, dtype).items():
            spec[name] = ((cfg.n_layers,) + shape, ("layers",) + axes, dt)
    return spec


def stack_prefill(cfg: ModelConfig, layers: list[dict], descs, x, cache_len: int):
    caches = []
    for desc, p in zip(descs, layers):
        x, c = sublayer_prefill(cfg, desc, p, x, cache_len)
        caches.append(c)
    return x, {name: torch.stack([c[name] for c in caches]) for name in caches[0]}


def stack_decode(cfg: ModelConfig, layers: list[dict], descs, x, cache, pos: int):
    """Updates ``cache`` in place, layer ``i`` through its slice."""
    for i, (desc, p) in enumerate(zip(descs, layers)):
        x, _ = sublayer_decode(cfg, desc, p, x, {name: c[i] for name, c in cache.items()}, pos)
    return x, cache
