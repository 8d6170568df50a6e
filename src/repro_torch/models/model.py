"""Public model API: ``build(cfg) -> Model`` with init/apply/prefill/decode_step.

The port of the reference's ``models/model.py`` for the decoder-only archs:
dense and MoE (GQA and MLA attention), ssm (RWKV6) and hybrid (Mamba with
attention layers between, jamba). The encoder-decoder (whisper) and the vlm
prefix (llava) wait for ROADMAP module 12.
``Model`` is an ``nn.Module`` that holds its parameters (fp32 masters, or
the config's ``param_dtype``); the reference passes a parameter pytree into
each call instead. Every forward casts them once into compute-dtype copies
(the reference's ``cast_floating`` on each call), kept until a parameter
changes.

  * ``apply(batch)``                       — full forward, f32 logits (B, S, V)
  * ``prefill(batch, cache_len)``          — forward + decode-cache construction
  * ``decode_step(cache, tokens, pos)``    — one-token serve step; updates
    ``cache`` in place and returns it
  * ``param_specs`` / ``cache_spec``       — ParamSpec / (shape, axes, dtype)
    trees in the reference's layouts

Batch key: ``"tokens"`` (B, S) ints. Everything runs without autograd.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import ParamSpec, count_params, flatten_specs, init_param, rms_norm

#: families this port runs; the audio and vlm archs wait for ROADMAP module 12
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def lm_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamSpec((v, d), ("vocab", "embed")),
        "stack": transformer.stack_specs(cfg),
        "ln_f": ParamSpec((d,), ("embed",), init="ones"),
        "unembed": ParamSpec((d, v), ("embed", "vocab")),
    }


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port does not run yet."""
    if cfg.family not in PORTED_FAMILIES or cfg.encoder_decoder or cfg.n_prefix_embeds:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported: the port runs the dense, moe, ssm and hybrid configs; "
            "the encoder-decoder (audio) and the prefix embeddings (vlm) wait for ROADMAP module 12")


class Model(nn.Module):
    """A decoder LM (GQA, MLA, RWKV6 or Mamba mixers; dense, MoE or cmix
    FFNs) on ``device`` (``None`` means ``cuda``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.param_dtype)
        d, v = cfg.d_model, cfg.vocab_size
        self.descs = transformer.layer_descs(cfg)
        self.embed = nn.Parameter(torch.empty((v, d), dtype=dtype, device=dev), requires_grad=False)
        self.layers = nn.ModuleList(transformer.Sublayer(cfg, desc, dtype, dev) for desc in self.descs)
        self.ln_f = nn.Parameter(torch.empty((d,), dtype=dtype, device=dev), requires_grad=False)
        self.unembed = nn.Parameter(torch.empty((d, v), dtype=dtype, device=dev), requires_grad=False)
        self._cast_key = None
        self._cast = None

    # ------------------------------------------------------------- params
    @property
    def param_specs(self) -> dict:
        """The reference's spec tree (the layers stacked under ``stack.blocks``)."""
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

    def params(self) -> dict:
        """The parameters in the compute dtype, as the reference's nested dict
        (``layers`` a list): cast once, again only after a parameter changed."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if key != self._cast_key:
            cdt = self.compute_dtype
            self._cast = {
                "embed": self.embed.detach().to(cdt),
                "layers": [layer.tree(cdt) for layer in self.layers],
                "ln_f": self.ln_f.detach().to(cdt),
                "unembed": self.unembed.detach().to(cdt),
            }
            self._cast_key = key
        return self._cast

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def hidden(self, batch) -> torch.Tensor:
        """Final normed hidden states (B, S, d)."""
        p = self.params()
        x = p["embed"][self._tokens(batch["tokens"])]
        x = transformer.stack_apply(self.cfg, p["layers"], self.descs, x)
        return rms_norm(x, p["ln_f"], self.cfg.norm_eps)

    @torch.no_grad()
    def apply(self, batch) -> torch.Tensor:
        return (self.hidden(batch) @ self.params()["unembed"]).float()

    # ------------------------------------------------------------- serve
    def cache_spec(self, batch: int, cache_len: int):
        return transformer.stack_cache_spec(self.cfg, batch, cache_len, self.compute_dtype)

    def init_cache(self, batch: int, cache_len: int) -> dict:
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, (shape, _, dt) in self.cache_spec(batch, cache_len).items()}

    @torch.no_grad()
    def prefill(self, batch, cache_len: int):
        """Returns (logits (B, S, V) f32, cache)."""
        p = self.params()
        x = p["embed"][self._tokens(batch["tokens"])]
        x, cache = transformer.stack_prefill(self.cfg, p["layers"], self.descs, x, cache_len)
        x = rms_norm(x, p["ln_f"], self.cfg.norm_eps)
        return (x @ p["unembed"]).float(), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B, 1) ints; pos: this token's position. Returns (logits
        (B, V) f32, cache), the cache updated in place."""
        p = self.params()
        x = p["embed"][self._tokens(tokens)]
        x, cache = transformer.stack_decode(self.cfg, p["layers"], self.descs, x, cache, int(pos))
        x = rms_norm(x, p["ln_f"], self.cfg.norm_eps)
        return (x[:, -1, :] @ p["unembed"]).float(), cache


def build(cfg: ModelConfig, device=None) -> Model:
    """A model of ``cfg`` on ``device`` (``None`` means ``cuda``), its
    parameters not yet filled: call ``init`` or ``convert.params_from_jax``.
    Raises ``NotImplementedError`` for a family the port does not run yet."""
    return Model(cfg, device)
