"""Public model API: ``build(cfg) -> Model`` with init/apply/prefill/decode_step.

The port of the reference's ``models/model.py`` for every arch: the decoder
stacks, dense and MoE (GQA and MLA attention), ssm (RWKV6) and hybrid (Mamba
with attention layers between, jamba), with the vlm's prefix embeddings
(llava) before the text; and the encoder-decoder (whisper,
:mod:`repro_torch.models.whisper`).
``Model`` is an ``nn.Module`` that holds its parameters (fp32 masters, or
the config's ``param_dtype``); the reference passes a parameter pytree into
each call instead. A served forward casts them once into compute-dtype
copies (the reference's ``cast_floating`` on each call), kept until a
parameter changes; a forward that autograd records casts them on every
call, as the reference does, so that the gradient reaches the masters.

  * ``apply(batch)``                       — full forward, f32 logits (B, S, V)
  * ``prefill(batch, cache_len)``          — forward + decode-cache construction
  * ``decode_step(cache, tokens, pos)``    — one-token serve step; updates
    ``cache`` in place and returns it
  * ``param_specs`` / ``cache_spec``       — ParamSpec / (shape, axes, dtype)
    trees in the reference's layouts

Batch keys: ``"tokens"`` (B, S) ints always; ``"prefix_embeds"`` (B,
n_prefix_embeds, d) for the vlm (cast to the compute dtype and put before the
text: positions run over both) and ``"enc_embeds"`` (B, S_src, d) for the
encoder-decoder (its ``cache_len`` is the source length, and its self cache
is ``max_target_positions`` long). ``apply``, ``prefill`` and
``decode_step`` run without autograd; ``hidden`` takes master tensors
(``params=``) and is differentiable in them, which the train loss uses.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer, whisper
from repro_torch.models.common import ParamSpec, count_params, flatten_specs, init_param, records, rms_norm


def lm_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamSpec((v, d), ("vocab", "embed")),
        "stack": transformer.stack_specs(cfg),
        "ln_f": ParamSpec((d,), ("embed",), init="ones"),
        "unembed": ParamSpec((d, v), ("embed", "vocab")),
    }


class Model(nn.Module):
    """A decoder LM (GQA, MLA, RWKV6 or Mamba mixers; dense, MoE or cmix
    FFNs; prefix embeddings before the text for the vlm), or the
    encoder-decoder (``encoder.<i>`` and ``decoder.<i>`` layers, ``descs``
    empty), on ``device`` (``None`` means ``cuda``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.param_dtype)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(torch.empty((v, d), dtype=dtype, device=dev), requires_grad=False)
        if cfg.encoder_decoder:
            self.descs = []
            self.encoder = nn.ModuleList(transformer.ParamTree(whisper._enc_layer_specs(cfg), dtype, dev)
                                         for _ in range(cfg.n_encoder_layers))
            self.enc_ln_f = nn.Parameter(torch.empty((d,), dtype=dtype, device=dev), requires_grad=False)
            self.decoder = nn.ModuleList(transformer.ParamTree(whisper._dec_layer_specs(cfg), dtype, dev)
                                         for _ in range(cfg.n_layers))
        else:
            self.descs = transformer.layer_descs(cfg)
            self.layers = nn.ModuleList(transformer.Sublayer(cfg, desc, dtype, dev) for desc in self.descs)
        self.ln_f = nn.Parameter(torch.empty((d,), dtype=dtype, device=dev), requires_grad=False)
        self.unembed = nn.Parameter(torch.empty((d, v), dtype=dtype, device=dev), requires_grad=False)
        self._cast_key = None
        self._cast = None

    # ------------------------------------------------------------- params
    @property
    def param_specs(self) -> dict:
        """The reference's spec tree (the layers stacked under ``stack.blocks``,
        or under ``encoder`` and ``decoder``)."""
        if self.cfg.encoder_decoder:
            return whisper.whisper_specs(self.cfg)
        return lm_specs(self.cfg)

    @property
    def n_params(self) -> int:
        return count_params(self.param_specs)

    @property
    def n_active_params(self) -> int:
        """Per-token active params (MoE: routed fraction only). The
        reference's formula as written: it also takes ``n_shared_experts``
        routed experts' worth off, though the shared experts are separate
        weights that every token reads."""
        cfg = self.cfg
        if not cfg.n_experts:
            return self.n_params
        total = 0
        f = cfg.moe_d_ff or cfg.d_ff
        per_expert = 3 * cfg.d_model * f if cfg.act == "swiglu" else 2 * cfg.d_model * f
        for i in range(cfg.n_layers):
            if cfg.moe_at(i):
                total += per_expert * (cfg.n_experts - cfg.experts_per_token - cfg.n_shared_experts)
        return self.n_params - total

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def port_specs(self) -> dict[str, ParamSpec]:
        """``{parameter name: ParamSpec}`` in this module's (unstacked) layout."""
        if self.cfg.encoder_decoder:
            return whisper.port_specs(self.cfg)
        specs = {"embed": ParamSpec((self.cfg.vocab_size, self.cfg.d_model), ("vocab", "embed"))}
        for i, desc in enumerate(self.descs):
            layer = flatten_specs(transformer.sublayer_specs(self.cfg, desc))
            specs.update({f"layers.{i}.{k}": s for k, s in layer.items()})
        specs["ln_f"] = ParamSpec((self.cfg.d_model,), ("embed",), init="ones")
        specs["unembed"] = ParamSpec((self.cfg.d_model, self.cfg.vocab_size), ("embed", "vocab"))
        return specs

    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter as the reference's ``init_params`` does (normal
        x 0.02, ones, zeros), from ``generator`` (on the model's device). The draws are
        not JAX's: to compare with the reference, carry its weights across
        with :func:`repro_torch.models.convert.params_from_jax`."""
        specs = self.port_specs()
        for name, param in self.named_parameters():
            init_param(param, specs[name], generator)
        return self

    def params(self, masters: dict | None = None) -> dict:
        """The parameters in the compute dtype, as the reference's nested dict
        (``layers``, ``encoder`` and ``decoder`` lists of layer dicts).

        ``masters`` (``{parameter name: tensor}``, the names of
        ``named_parameters``) are cast on every call, the cast recorded by
        autograd, as the reference casts its pytree on every call, so that a
        gradient reaches the masters. Without ``masters``, the model's own
        parameters: cast again on every call while autograd records on them
        (grad enabled, a parameter that requires grad); else cast once and
        kept until a parameter changes (every served forward)."""
        if masters is not None:
            return self._nest(masters)
        named = dict(self.named_parameters())
        if records(named):
            return self._nest(named)
        key = tuple((p.data_ptr(), p._version) for p in named.values())
        if key != self._cast_key:
            self._cast = self._nest({name: p.detach() for name, p in named.items()})
            self._cast_key = key
        return self._cast

    def _nest(self, flat: dict) -> dict:
        """``{"layers.0.mixer.wq": tensor, ...}`` -> the nested dict, each
        tensor cast to the compute dtype (no copy where it has it already)."""
        cdt = self.compute_dtype
        out: dict = {}
        for name, tensor in flat.items():
            *path, leaf = name.split(".")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = tensor.to(cdt)
        for stack in ("layers", "encoder", "decoder"):
            if stack in out:
                out[stack] = [out[stack][str(i)] for i in range(len(out[stack]))]
        return out

    def unembed_weight(self, params: dict) -> torch.Tensor:
        """The reference's ``Model.unembed``: the unembedding of ``params``
        as given (the train loss's masters; the name ``unembed`` is this
        module's parameter)."""
        return params["unembed"]

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embeds(self, embeds) -> torch.Tensor:
        return torch.as_tensor(embeds, device=self.device).to(self.compute_dtype)

    def _embed_tokens(self, p: dict, batch) -> torch.Tensor:
        """The token embeddings, after the prefix embeddings where the config
        has them (the reference's ``_embed_tokens``)."""
        x = p["embed"][self._tokens(batch["tokens"])]
        if self.cfg.n_prefix_embeds:
            x = torch.cat([self._embeds(batch["prefix_embeds"]), x], dim=1)
        return x

    # ------------------------------------------------------------ forward
    def hidden(self, batch, params: dict | None = None) -> torch.Tensor:
        """Final normed hidden states (B, S, d) (the decoder's, S the target
        length, for the encoder-decoder), computed with ``params`` (master
        tensors by parameter name; the model's own where None). Autograd
        records it where it records on the parameters (training): then every
        attention call takes the plain path and each layer is rematerialised
        where ``cfg.remat`` is set."""
        p = self.params(params)
        if self.cfg.encoder_decoder:
            return whisper.hidden(self.cfg, p, self._embeds(batch["enc_embeds"]), self._tokens(batch["tokens"]))
        x = self._embed_tokens(p, batch)
        x = transformer.stack_apply(self.cfg, p["layers"], self.descs, x)
        return rms_norm(x, p["ln_f"], self.cfg.norm_eps)

    @torch.no_grad()
    def apply(self, batch) -> torch.Tensor:
        return (self.hidden(batch) @ self.params()["unembed"]).float()

    # ------------------------------------------------------------- serve
    def cache_spec(self, batch: int, cache_len: int):
        """``{name: (shape, logical_axes, dtype)}`` of the decode cache; for the
        encoder-decoder ``cache_len`` is the source length."""
        if self.cfg.encoder_decoder:
            return whisper.cache_spec(self.cfg, batch, cache_len, self.compute_dtype)
        return transformer.stack_cache_spec(self.cfg, batch, cache_len, self.compute_dtype)

    def init_cache(self, batch: int, cache_len: int) -> dict:
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, (shape, _, dt) in self.cache_spec(batch, cache_len).items()}

    @torch.no_grad()
    def prefill(self, batch, cache_len: int):
        """Returns (logits (B, S, V) f32, cache). The encoder-decoder ignores
        ``cache_len``: its cross cache takes the source's length, its self
        cache ``max_target_positions``."""
        p = self.params()
        if self.cfg.encoder_decoder:
            return whisper.prefill(self.cfg, p, self._embeds(batch["enc_embeds"]), self._tokens(batch["tokens"]))
        x = self._embed_tokens(p, batch)
        x, cache = transformer.stack_prefill(self.cfg, p["layers"], self.descs, x, cache_len)
        x = rms_norm(x, p["ln_f"], self.cfg.norm_eps)
        return (x @ p["unembed"]).float(), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B, 1) ints; pos: this token's position. Returns (logits
        (B, V) f32, cache), the cache updated in place. The vlm's text
        positions come after its prefix: ``pos`` counts the prefix too."""
        p = self.params()
        if self.cfg.encoder_decoder:
            return whisper.decode_step(self.cfg, p, cache, self._tokens(tokens), int(pos))
        x = p["embed"][self._tokens(tokens)]
        x, cache = transformer.stack_decode(self.cfg, p["layers"], self.descs, x, cache, int(pos))
        x = rms_norm(x, p["ln_f"], self.cfg.norm_eps)
        return (x[:, -1, :] @ p["unembed"]).float(), cache


def build(cfg: ModelConfig, device=None) -> Model:
    """A model of ``cfg`` on ``device`` (``None`` means ``cuda``), its
    parameters not yet filled: call ``init`` or ``convert.params_from_jax``."""
    return Model(cfg, device)
