"""Decoder stack: the port of the reference's ``models/transformer.py``
(``layer_descs``, ``stack_pattern``, and the sublayer's dispatch on its
``LayerDesc``: the ``gqa``/``mla``/``rwkv6``/``mamba`` mixers and the
``dense``/``moe``/``cmix`` FFNs).

The reference scans stacked blocks with ``lax.scan``; here the stack is an
``nn.ModuleList`` of :class:`Sublayer`, one a layer (prefix layers included),
walked by a Python loop (each layer rematerialised in a recorded forward
where ``cfg.remat`` is set, as the reference checkpoints its blocks). The
decode cache is a flat dict, each name stacked over the layers that hold it,
in layer order (:func:`cache_slots`): every
layer for the dense, MoE and RWKV6 stacks (``{"k": (L, B, S, KH, D), "v"}``
for GQA, ``{"ckv": (L, B, S, kv_lora), "k_rope"}`` for MLA, ``{"state": (L,
B, H, N, N), "prev_x", "prev_x_c"}`` for RWKV6); in a hybrid, ``k``/``v``
over its attention layers and ``h``/``conv`` over its Mamba layers. Layer
``i`` reads and writes its slot of each name it holds, in place.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.common import ParamSpec, mlp_apply, mlp_specs, remat, rms_norm


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


# --------------------------------------------------------------- sublayer


def _mixer_specs(cfg, desc):
    if desc.mixer == "gqa":
        return attn.gqa_specs(cfg)
    if desc.mixer == "mla":
        return attn.mla_specs(cfg)
    if desc.mixer == "rwkv6":
        return ssm.rwkv6_specs(cfg)
    if desc.mixer == "mamba":
        return ssm.mamba_specs(cfg)
    raise ValueError(desc.mixer)


def _ffn_specs(cfg, desc):
    if desc.ffn == "dense":
        return mlp_specs(cfg.d_model, cfg.d_ff, cfg.act)
    if desc.ffn == "moe":
        return moe_mod.moe_specs(cfg)
    if desc.ffn == "cmix":
        return ssm.rwkv6_cmix_specs(cfg)
    raise ValueError(desc.ffn)


def sublayer_specs(cfg: ModelConfig, desc: LayerDesc) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "mixer": _mixer_specs(cfg, desc),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "ffn": _ffn_specs(cfg, desc),
    }


def ffn_input(cfg, p, x, mix):
    """``(x + mix, rms_norm(x + mix))``: the residual after the mixer, in the
    compute dtype, and the FFN's input. The norm reads the sum before its
    rounding to bf16, as the reference's fused XLA computation does (its
    residual is rounded); in f32 the two are the same."""
    return x + mix, rms_norm(x.float() + mix.float(), p["ln2"], cfg.norm_eps).to(x.dtype)


def sublayer_ffn(cfg, desc, p, x, mix, prev_x=None):
    """The sublayer's second half: ``x + mix + ffn(rms_norm(x + mix))``.
    Returns (out, last): ``last`` is cmix's token-shift carry (``prev_x_c``;
    ``prev_x`` the one it starts from), None for the dense and MoE FFNs."""
    x, h = ffn_input(cfg, p, x, mix)
    if desc.ffn == "dense":
        return x + mlp_apply(p["ffn"], h, cfg.act), None
    if desc.ffn == "moe":
        return x + moe_mod.moe_apply(p["ffn"], h, cfg), None
    if desc.ffn == "cmix":
        f, last = ssm.rwkv6_cmix_apply(p["ffn"], h, cfg, prev_x=prev_x)
        return x + f, last
    raise ValueError(desc.ffn)


def sublayer_apply(cfg, desc, p, x, *, causal=True):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if desc.mixer == "gqa":
        mix = attn.gqa_apply(p["mixer"], h, cfg, causal=causal)
    elif desc.mixer == "mla":
        mix = attn.mla_apply(p["mixer"], h, cfg, causal=causal)
    elif desc.mixer == "rwkv6":
        mix, _ = ssm.rwkv6_apply(p["mixer"], h, cfg)
    elif desc.mixer == "mamba":
        mix, _ = ssm.mamba_apply(p["mixer"], h, cfg)
    else:
        raise ValueError(desc.mixer)
    return sublayer_ffn(cfg, desc, p, x, mix)[0]


def sublayer_prefill(cfg, desc, p, x, cache_len):
    """Full-sequence pass that also emits this layer's decode cache."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if desc.mixer == "gqa":
        mix, cache = attn.gqa_prefill(p["mixer"], h, cfg, cache_len)
    elif desc.mixer == "mla":
        mix, cache = attn.mla_prefill(p["mixer"], h, cfg, cache_len)
    elif desc.mixer == "rwkv6":
        mix, (state, last) = ssm.rwkv6_apply(p["mixer"], h, cfg)
        cache = {"state": state, "prev_x": last}
    elif desc.mixer == "mamba":
        mix, cache = ssm.mamba_apply(p["mixer"], h, cfg)
    else:
        raise ValueError(desc.mixer)
    out, last_c = sublayer_ffn(cfg, desc, p, x, mix)
    if desc.ffn == "cmix":
        cache["prev_x_c"] = last_c
    return out, cache


def sublayer_decode(cfg, desc, p, x, cache, pos):
    """One token; updates ``cache`` (this layer's views) in place."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if desc.mixer == "gqa":
        mix, _ = attn.gqa_decode(p["mixer"], h, cache, pos, cfg)
    elif desc.mixer == "mla":
        mix, _ = attn.mla_decode(p["mixer"], h, cache, pos, cfg)
    elif desc.mixer == "rwkv6":
        mix, _ = ssm.rwkv6_decode(p["mixer"], h, cache, cfg)
    elif desc.mixer == "mamba":
        mix, _ = ssm.mamba_decode(p["mixer"], h, cache, cfg)
    else:
        raise ValueError(desc.mixer)
    out, last_c = sublayer_ffn(cfg, desc, p, x, mix, prev_x=cache.get("prev_x_c"))
    if desc.ffn == "cmix":
        cache["prev_x_c"].copy_(last_c)
    return out, cache


def sublayer_cache_spec(cfg, desc, batch, cache_len, dtype):
    """(shape, logical_axes, dtype) tree for this sublayer's decode cache."""
    if desc.mixer == "gqa":
        spec = attn.gqa_cache_spec(cfg, batch, cache_len, dtype)
    elif desc.mixer == "mla":
        spec = attn.mla_cache_spec(cfg, batch, cache_len, dtype)
    elif desc.mixer == "rwkv6":
        spec = ssm.rwkv6_cache_spec(cfg, batch, dtype)
    elif desc.mixer == "mamba":
        spec = ssm.mamba_cache_spec(cfg, batch, dtype)
    else:
        raise ValueError(desc.mixer)
    if desc.ffn == "cmix":
        spec["prev_x_c"] = ((batch, cfg.d_model), ("batch", None), dtype)
    return spec


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
    specs["blocks"] = stacked({str(j): sublayer_specs(cfg, d) for j, d in enumerate(pattern)}, n_blocks)
    return specs


def stacked(tree: dict, n: int) -> dict:
    """``tree``'s specs with a leading ``layers`` axis of ``n``: the reference's
    scanned layout."""
    return {k: ParamSpec((n,) + s.shape, ("layers",) + s.logical_axes, s.init, s.scale)
            if isinstance(s, ParamSpec) else stacked(s, n) for k, s in tree.items()}


def stack_apply(cfg: ModelConfig, layers: list[dict], descs, x, *, causal=True):
    """The layers in order; each rematerialised in the backward pass where
    ``cfg.remat`` is set and autograd records (the reference checkpoints
    each scanned block)."""
    for desc, p in zip(descs, layers):
        x = remat(cfg, sublayer_apply, cfg, desc, p, x, causal=causal)
    return x


def cache_slots(cfg: ModelConfig) -> list[dict[str, int]]:
    """Layer ``i``'s ``{cache name: slot}``: its place in the stack of that
    name, which holds the layers that carry it in layer order."""
    counts: dict[str, int] = {}
    slots = []
    for desc in layer_descs(cfg):
        names = sublayer_cache_spec(cfg, desc, 1, 1, torch.float32)
        slots.append({name: counts.get(name, 0) for name in names})
        for name in names:
            counts[name] = counts.get(name, 0) + 1
    return slots


def stack_cache_spec(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    """``{name: ((L_name,) + shape, ("layers",) + axes, dtype)}``, each name
    stacked over the ``L_name`` layers that hold it (all ``n_layers`` but in
    a hybrid)."""
    spec = {}
    for desc in layer_descs(cfg):
        for name, (shape, axes, dt) in sublayer_cache_spec(cfg, desc, batch, cache_len, dtype).items():
            n = spec[name][0][0] + 1 if name in spec else 1
            spec[name] = ((n,) + shape, ("layers",) + axes, dt)
    return spec


def stack_prefill(cfg: ModelConfig, layers: list[dict], descs, x, cache_len: int):
    caches = []
    for desc, p in zip(descs, layers):
        x, c = sublayer_prefill(cfg, desc, p, x, cache_len)
        caches.append(c)
    names = dict.fromkeys(name for c in caches for name in c)
    return x, {name: torch.stack([c[name] for c in caches if name in c]) for name in names}


def stack_decode(cfg: ModelConfig, layers: list[dict], descs, x, cache, pos: int):
    """Updates ``cache`` in place, layer ``i`` through its slots."""
    for desc, p, slots in zip(descs, layers, cache_slots(cfg)):
        x, _ = sublayer_decode(cfg, desc, p, x, {name: cache[name][j] for name, j in slots.items()}, pos)
    return x, cache
