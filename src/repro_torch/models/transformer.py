"""Decoder stack: the port of the reference's ``models/transformer.py``
(``layer_descs``, ``stack_pattern``, and the sublayer's dispatch on its
``LayerDesc`` for the ``gqa``/``mla`` mixers and the ``dense``/``moe`` FFNs).

The reference scans stacked blocks with ``lax.scan``; here the stack is an
``nn.ModuleList`` of :class:`Sublayer`, one a layer (prefix layers included),
walked by a Python loop. The decode cache is stacked over every layer:
``{"k": (L, B, S, KH, D), "v": ...}`` for GQA, ``{"ckv": (L, B, S, kv_lora),
"k_rope": (L, B, S, rope_dim)}`` for MLA, layer ``i`` reading and writing its
slice. RWKV6, Mamba and cmix layers wait (ROADMAP module 12).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ParamSpec, mlp_apply, mlp_specs, rms_norm


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


def _unported(what: str):
    return NotImplementedError(f"{what} layers are not ported: the port runs gqa and mla mixers with dense and "
                               "moe FFNs; rwkv6, mamba and cmix wait for ROADMAP module 12")


# --------------------------------------------------------------- sublayer


def _mixer_specs(cfg, desc):
    if desc.mixer == "gqa":
        return attn.gqa_specs(cfg)
    if desc.mixer == "mla":
        return attn.mla_specs(cfg)
    raise _unported(desc.mixer)


def _ffn_specs(cfg, desc):
    if desc.ffn == "dense":
        return mlp_specs(cfg.d_model, cfg.d_ff, cfg.act)
    if desc.ffn == "moe":
        return moe_mod.moe_specs(cfg)
    raise _unported(desc.ffn)


def sublayer_specs(cfg: ModelConfig, desc: LayerDesc) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mixer": _mixer_specs(cfg, desc),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ffn": _ffn_specs(cfg, desc),
    }


def sublayer_ffn(cfg, desc, p, x):
    """The sublayer's second half: ``x + ffn(rms_norm(x))``, dense or MoE."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if desc.ffn == "dense":
        return x + mlp_apply(p["ffn"], h, cfg.act)
    if desc.ffn == "moe":
        return x + moe_mod.moe_apply(p["ffn"], h, cfg)
    raise _unported(desc.ffn)


def sublayer_apply(cfg, desc, p, x, *, causal=True):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if desc.mixer == "gqa":
        mix = attn.gqa_apply(p["mixer"], h, cfg, causal=causal)
    elif desc.mixer == "mla":
        mix = attn.mla_apply(p["mixer"], h, cfg, causal=causal)
    else:
        raise _unported(desc.mixer)
    return sublayer_ffn(cfg, desc, p, x + mix)


def sublayer_prefill(cfg, desc, p, x, cache_len):
    """Full-sequence pass that also emits this layer's decode cache."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if desc.mixer == "gqa":
        mix, cache = attn.gqa_prefill(p["mixer"], h, cfg, cache_len)
    elif desc.mixer == "mla":
        mix, cache = attn.mla_prefill(p["mixer"], h, cfg, cache_len)
    else:
        raise _unported(desc.mixer)
    return sublayer_ffn(cfg, desc, p, x + mix), cache


def sublayer_decode(cfg, desc, p, x, cache, pos):
    """One token; updates ``cache`` (this layer's views) in place."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if desc.mixer == "gqa":
        mix, cache = attn.gqa_decode(p["mixer"], h, cache, pos, cfg)
    elif desc.mixer == "mla":
        mix, cache = attn.mla_decode(p["mixer"], h, cache, pos, cfg)
    else:
        raise _unported(desc.mixer)
    return sublayer_ffn(cfg, desc, p, x + mix), cache


def sublayer_cache_spec(cfg, desc, batch, cache_len, dtype):
    """(shape, logical_axes, dtype) tree for this sublayer's decode cache."""
    if desc.mixer == "gqa":
        return attn.gqa_cache_spec(cfg, batch, cache_len, dtype)
    if desc.mixer == "mla":
        return attn.mla_cache_spec(cfg, batch, cache_len, dtype)
    raise _unported(desc.mixer)


class ParamTree(nn.Module):
    """A nested spec tree as modules: a parameter a ``ParamSpec`` leaf, a child
    module a dict, so that the parameter names are the reference's paths
    (``ffn.shared.w_gate``)."""

    def __init__(self, specs: dict, dtype: torch.dtype, device):
        super().__init__()
        for name, value in specs.items():
            if isinstance(value, ParamSpec):
                self.register_parameter(name, _param(value, dtype, device))
            else:
                self.add_module(name, ParamTree(value, dtype, device))

    def tree(self, dtype: torch.dtype) -> dict:
        """The parameters as the reference's nested dict, cast to ``dtype``
        (no copy where they already have it)."""
        out = {name: p.detach().to(dtype) for name, p in self.named_parameters(recurse=False)}
        out.update({name: child.tree(dtype) for name, child in self.named_children()})
        return out


class Sublayer(ParamTree):
    """One layer's parameters (``ln1``, ``mixer``, ``ln2``, ``ffn``), named as
    the reference's tree under ``stack.blocks.<j>`` (or ``stack.prefix.<i>``)
    without the layers axis."""

    def __init__(self, cfg: ModelConfig, desc: LayerDesc, dtype: torch.dtype, device):
        super().__init__(sublayer_specs(cfg, desc), dtype, device)
        self.desc = desc


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
    """``{name: ((L,) + shape, ("layers",) + axes, dtype)}`` over every layer
    (``k``/``v`` for GQA, ``ckv``/``k_rope`` for MLA)."""
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
