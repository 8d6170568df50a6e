"""AdamW + schedules on dicts of tensors: the port of the reference's
``train/optimizer.py`` (no optax there, no ``torch.optim`` here).

The reference's state is a pytree shaped like the params; here the params are
a dict ``{name: tensor}``, ``m`` and ``v`` dicts with the same keys and
``step`` a 0-d int32 tensor on the params' device. ``state_dtype`` sets the
precision of ``m`` and ``v`` (bf16 for the >100B configs). The math is done
in f32, in the reference's order, and each parameter is updated in its own
dtype. ``torch.optim.AdamW`` orders its decay and bias correction otherwise
and keeps no bf16 state, so it is not used. The update walks the tensors one
at a time (about a dozen launches each).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"  # "bfloat16" for the >100B configs


def adamw_init(params: dict, cfg: OptConfig) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    device = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def lr_schedule(step, cfg: OptConfig) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine to 10 % of it (f32)."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1).float() / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).float() / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)  # decay to 10% of peak


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


def adamw_update(grads: dict, state: dict, params: dict, cfg: OptConfig) -> tuple[dict, dict, torch.Tensor]:
    """Returns (new_params, new_state, lr): new tensors, the inputs untouched.
    Math in f32, state stored in ``cfg.state_dtype``, params updated in their
    own dtype."""
    step = state["step"] + 1
    lr = lr_schedule(step, cfg)
    sdt = getattr(torch, cfg.state_dtype)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        mh = m32 / c1
        vh = v32 / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m32.to(sdt), v32.to(sdt)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        new_p[k], new_m[k], new_v[k] = upd(p, grads[k], state["m"][k], state["v"][k])
    return new_p, {"m": new_m, "v": new_v, "step": step}, lr
