"""Mixture-of-Experts FFN: sort-based capacity dispatch.

The port of the reference's ``models/moe.py``. Each batch row sorts its S·k
token copies by expert id, gives each copy its position within its expert,
and drops the copies at or past the per-row capacity ``C``; the kept copies
fill per-expert capacity buffers ``(B, E, C, d)`` on which the experts run as
batched products. ``moe_apply`` is three steps that the tests pin one by one:

  * :func:`route`    — router logits in f32, the top k (the lower expert id
    first among equal logits, as ``jax.lax.top_k``), softmax weights in the
    compute dtype;
  * :func:`dispatch` — a stable sort of each row's copies by expert id, each
    copy's position within its expert, the capacity drop, and the buffers;
  * :func:`expert_ffn` and :func:`combine` — the experts on the buffers, and
    each token's kept copies summed with their weights (a dropped copy adds 0).

The shared experts are added after the combine. There is one device and no
sharding rules here, so the port follows the reference's unsharded path (its
``shard_map`` islands wait for the port's sharding module).

At decode (S = 1) the capacity is 8 and every expert's buffer is multiplied,
so each token reads every expert's weights, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, activation


def moe_specs(cfg: ModelConfig, prefix=()) -> dict:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts
    ax = tuple(prefix)
    specs = {
        "router": ParamSpec((d, e), ax + ("embed", "experts_in")),
        "w_gate": ParamSpec((e, d, f), ax + ("experts", "embed", "mlp")),
        "w_up": ParamSpec((e, d, f), ax + ("experts", "embed", "mlp")),
        "w_down": ParamSpec((e, f, d), ax + ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        specs["shared"] = {
            "w_gate": ParamSpec((d, fs), ax + ("embed", "mlp")),
            "w_up": ParamSpec((d, fs), ax + ("embed", "mlp")),
            "w_down": ParamSpec((fs, d), ax + ("mlp", "embed")),
        }
    return specs


def _capacity(tokens_per_row: int, cfg: ModelConfig) -> int:
    c = int(tokens_per_row * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values and their
    indices, the lower index first among equal values (a stable descending
    sort; ``torch.topk`` promises no order among ties)."""
    values, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def route(router: torch.Tensor, x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (weights (B, S, k) in x's dtype, expert ids (B, S, k)):
    the router product in x's dtype cast to f32, its top k, and the softmax
    over them in f32 cast back, as the reference rounds them."""
    logits = torch.einsum("bsd,de->bse", x, router).float()
    topw, topi = top_k(logits, k)
    return torch.softmax(topw, dim=-1).to(x.dtype), topi


@dataclasses.dataclass
class Dispatch:
    """One call's dispatch, each copy in token order (copy ``i`` is token
    ``i // k``'s ``i % k``-th choice): its expert, its position within the
    expert (in the row's stable sort by expert id), whether it is kept
    (position < capacity), and the capacity buffers ``(B, E, C, d)``."""

    eid: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    buf: torch.Tensor


def dispatch(x: torch.Tensor, eid: torch.Tensor, n_experts: int, k: int, cap: int) -> Dispatch:
    """x (B, S, d), eid (B, S·k) -> :class:`Dispatch`. A row's copies are
    sorted by expert id, stably (the earlier copy first within an expert);
    a copy's position is its rank within its expert; copies at position >=
    ``cap`` are dropped, scattered nowhere."""
    b, s, d = x.shape
    dev = x.device
    order = torch.argsort(eid, dim=-1, stable=True)
    sorted_e = eid.gather(-1, order)
    experts = torch.arange(n_experts, device=dev).expand(b, n_experts).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")
    pos_sorted = torch.arange(s * k, device=dev)[None, :] - starts.gather(-1, sorted_e)
    # back to token order: copy order[r, j] sits at sorted place j
    pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
    keep = pos < cap
    rows = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    tok = torch.arange(s * k, device=dev)[None, :].expand(b, s * k) // k
    buf = torch.zeros((b, n_experts, cap, d), dtype=x.dtype, device=dev)
    buf[rows[keep], eid[keep], pos[keep]] = x[rows[keep], tok[keep]]
    return Dispatch(eid, pos, keep, buf)


def expert_ffn(params: dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    """Every expert on its capacity buffer: (B, E, C, d) -> (B, E, C, d)."""
    gate = torch.einsum("becd,edf->becf", buf, params["w_gate"])
    up = torch.einsum("becd,edf->becf", buf, params["w_up"]) if act == "swiglu" else None
    h = activation(act, gate, up)
    return torch.einsum("becf,efd->becd", h, params["w_down"])


def combine(y: torch.Tensor, disp: Dispatch, weights: torch.Tensor, k: int) -> torch.Tensor:
    """(B, E, C, d) expert outputs -> (B, S, d): each token's kept copies
    times their weights, summed over its k choices (a dropped copy adds 0).
    A gather and a sum, not a scatter-add: the same order on every run."""
    b, _, cap, d = y.shape
    rows = torch.arange(b, device=y.device)[:, None]
    vals = y[rows, disp.eid, disp.pos.clamp(max=cap - 1)] * disp.keep[..., None].to(y.dtype)
    vals = vals * weights.reshape(b, -1, 1).to(y.dtype)
    return vals.reshape(b, -1, k, d).sum(dim=2)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Capacity is per row: C = max(8, ceil8(S·k·cf / E))."""
    b, s, _ = x.shape
    k = cfg.experts_per_token
    weights, topi = route(params["router"], x, k)
    disp = dispatch(x, topi.reshape(b, s * k), cfg.n_experts, k, _capacity(s, cfg))
    y = expert_ffn(params, disp.buf, "swiglu" if cfg.act == "swiglu" else cfg.act)
    out = combine(y, disp, weights, k)
    if cfg.n_shared_experts:
        sh = params["shared"]
        out = out + activation("swiglu", x @ sh["w_gate"], x @ sh["w_up"]) @ sh["w_down"]
    return out


def aux_load_balance_loss(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary (mean over tokens)."""
    d = x.shape[-1]
    logits = (x.reshape(-1, d) @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    _, topi = top_k(logits, cfg.experts_per_token)
    frac = torch.zeros(cfg.n_experts, device=x.device).index_add_(
        0, topi.reshape(-1), torch.ones(topi.numel(), device=x.device)) / topi.numel()
    return cfg.n_experts * torch.sum(frac * probs.mean(0))
