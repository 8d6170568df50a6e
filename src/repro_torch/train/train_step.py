"""Train step factory: chunked cross-entropy + AdamW + grad clip, the port
of the reference's ``train/train_step.py``.

The loss never materialises the (B, S, vocab) f32 logits: the sequence is
processed in chunks whose logits are recomputed in the backward pass
(``torch.utils.checkpoint`` on the chunk body, the reference's
``jax.checkpoint``). The step is plain eager PyTorch: the model's forward as
autograd records it (every attention call on the plain path, each layer
rematerialised where ``cfg.remat`` is set), ``torch.autograd.grad``, and the
optimizer of :mod:`repro_torch.train.optimizer`. The reference's
``shard_hint`` calls are left out: outside a sharding-rules context they do
nothing, and the port has no sharding module yet.

Optional cross-pod gradient compression (int8 + stochastic rounding) is
applied to the gradients before the optimizer, its uniforms drawn from a
``torch.Generator`` seeded from (17, step): see train/compression.py.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.common import recomputed, records
from repro_torch.models.model import Model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.compression import compress_decompress_int8
from repro_torch.train.optimizer import OptConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    loss_chunk: int = 512  # sequence chunk for the xent loop
    grad_accum: int = 1  # microbatches per step (activation-memory control)
    accum_dtype: str = "float32"  # grad accumulator ("bfloat16" for >300B)
    moe_aux_weight: float = 0.0  # load-balance loss (off by default)
    compress_grads: bool = False  # int8 stochastic-rounding grad compression


def _xent_chunk(hc, w, lc, mc):
    """One chunk's summed masked NLL and mask count. The product takes the
    promoted dtype of ``hc`` and ``w`` (bf16 hidden states against f32
    masters: f32, as JAX promotes them), then f32 logits."""
    dt = torch.promote_types(hc.dtype, w.dtype)
    logits = (hc.to(dt) @ w.to(dt)).float()  # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, lc[..., None])[..., 0]
    nll = (lse - lab) * mc
    return nll.sum(), mc.sum()


def chunked_xent(h: torch.Tensor, w_unembed: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean masked NLL + token count. h (B, S, d), w_unembed (d, V), labels
    (B, S) ints, mask (B, S) {0, 1}. Logits exist only a chunk at a time,
    recomputed in the backward pass where autograd records."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # fall back to a single chunk for ragged tails
    remat = records(h, w_unembed)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        args = (h[:, c0:c0 + chunk], w_unembed, labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk])
        nll, m = recomputed(_xent_chunk, *args) if remat else _xent_chunk(*args)
        tot, cnt = tot + nll, cnt + m
    return tot / torch.clamp(cnt, min=1.0), cnt


def make_loss_fn(model: Model, tcfg: TrainConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss, {"loss", "tokens"})``: next-token
    NLL of ``model`` with ``params`` (master tensors by parameter name), the
    last position masked; the vlm's loss over its text only."""
    cfg = model.cfg

    def loss_fn(params, batch):
        h = model.hidden(batch, params)  # (B, S_total, d)
        tokens = torch.as_tensor(batch["tokens"], device=h.device).long()
        if cfg.n_prefix_embeds:  # vlm: loss only over the text tail
            h = h[:, cfg.n_prefix_embeds:, :]
        # next-token prediction: h[:, t] predicts tokens[:, t+1]. Keep the full
        # S so the chunking stays divisible; mask out the final position.
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = batch.get("loss_mask")
        mask = (torch.ones(labels.shape, dtype=torch.float32, device=h.device) if mask is None
                else torch.as_tensor(mask, device=h.device).float().clone())
        mask[:, -1] = 0.0
        loss, cnt = chunked_xent(h, model.unembed_weight(params), labels, mask, tcfg.loss_chunk)
        return loss, {"loss": loss, "tokens": cnt}

    return loss_fn


def value_and_grad(loss_fn: Callable, params: dict, batch) -> tuple[tuple, dict]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)``: the
    gradient of the loss in every parameter (zeros where the loss does not
    reach it), in the parameter's dtype; the values detached."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(leaves.items(), grads)}
    return (loss.detach(), {k: a.detach() for k, a in aux.items()}), grads


def compression_generator(step: int, device) -> torch.Generator:
    """The compression's generator at optimizer step ``step``: seeded from
    (17, step), as the reference folds the step into ``PRNGKey(17)``."""
    return torch.Generator(device=device).manual_seed((17 << 32) | int(step))


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    new tensors for the params and state (the inputs are not written)."""
    loss_fn = make_loss_fn(model, tcfg)

    def grads_of(params, batch):
        if tcfg.grad_accum <= 1:
            return value_and_grad(loss_fn, params, batch)
        # gradient accumulation over microbatches (the batch's leading axis
        # split in n), the gradients summed in accum_dtype and divided by n
        n = tcfg.grad_accum
        adt = getattr(torch, tcfg.accum_dtype)
        acc_g = {k: torch.zeros(p.shape, dtype=adt, device=p.device) for k, p in params.items()}
        acc_loss = torch.zeros((), dtype=torch.float32, device=model.device)
        acc_tok = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(n):
            mb = {k: a[i * (a.shape[0] // n):(i + 1) * (a.shape[0] // n)] if getattr(a, "ndim", 0) else a
                  for k, a in batch.items()}
            (loss, aux), g = value_and_grad(loss_fn, params, mb)
            acc_g = {k: acc_g[k] + g[k].to(adt) for k in acc_g}
            acc_loss, acc_tok = acc_loss + loss, acc_tok + aux["tokens"]
        return (acc_loss / n, {"tokens": acc_tok}), {k: a / n for k, a in acc_g.items()}

    def train_step(params, opt_state, batch):
        (loss, aux), grads = grads_of(params, batch)
        if tcfg.compress_grads:
            grads = compress_decompress_int8(grads, compression_generator(opt_state["step"], model.device))
        grads, gnorm = opt_mod.clip_by_global_norm(grads, tcfg.opt.grad_clip)
        params, opt_state, lr = opt_mod.adamw_update(grads, opt_state, params, tcfg.opt)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, "tokens": aux["tokens"]}
        return params, opt_state, metrics

    return train_step


def init_train_state(model: Model, tcfg: TrainConfig, generator: torch.Generator) -> tuple[dict, dict]:
    """``model``'s parameters drawn from ``generator`` (on its device) as the
    masters ``{name: tensor}`` (the model's own tensors: a step returns new
    ones), and a fresh optimizer state."""
    model.init(generator)
    params = {name: p.detach() for name, p in model.named_parameters()}
    return params, opt_mod.adamw_init(params, tcfg.opt)
