"""Carry the reference package's weights into a port model.

The reference keeps a parameter pytree whose repeating layers are stacked
under ``stack.blocks.<j>`` on a leading ``layers`` axis (``<j>`` the layer's
place in the repeating pattern) and whose leading dense layers sit under
``stack.prefix.<i>``; the encoder-decoder stacks its layers under ``encoder``
(``n_encoder_layers`` on the leading axis) and ``decoder`` (``n_layers``).
:func:`params_from_jax` takes that tree as numpy arrays (for instance
``jax.tree_util.tree_map(np.asarray, params)``), unstacks the blocks into the
port's ``layers.<i>`` (or ``encoder.<i>`` and ``decoder.<i>``) and loads every
array, so that both packages compute with the same weights. It imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.model import Model


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def port_arrays(cfg, tree) -> dict[str, np.ndarray]:
    """The reference's tree as ``{port parameter name: array}``."""
    prefix, pattern, n_blocks = transformer.stack_pattern(cfg)
    stacks = {"encoder": cfg.n_encoder_layers, "decoder": cfg.n_layers} if cfg.encoder_decoder else {}
    out = {}
    for name, array in _flatten(tree).items():
        parts = name.split(".")
        if parts[0] in stacks:
            n, rest = stacks[parts[0]], ".".join(parts[1:])
            if array.shape[0] != n:
                raise ValueError(f"{name}: {array.shape[0]} stacked layers, the config has {n}")
            for i in range(n):
                out[f"{parts[0]}.{i}.{rest}"] = array[i]
        elif parts[0] == "stack" and parts[1] == "blocks":
            j, rest = int(parts[2]), ".".join(parts[3:])
            if array.shape[0] != n_blocks:
                raise ValueError(f"{name}: {array.shape[0]} stacked blocks, the config has {n_blocks}")
            for blk in range(n_blocks):
                out[f"layers.{len(prefix) + blk * len(pattern) + j}.{rest}"] = array[blk]
        elif parts[0] == "stack" and parts[1] == "prefix":
            out[f"layers.{int(parts[2])}.{'.'.join(parts[3:])}"] = array
        else:
            out[name] = array
    return out


def params_from_jax(model: Model, tree) -> Model:
    """Load the reference's parameter tree (numpy arrays) into ``model``.
    Every parameter must get exactly one array of its shape; the arrays are
    cast to the model's parameter dtype."""
    arrays = port_arrays(model.cfg, tree)
    params = dict(model.named_parameters())
    if set(arrays) != set(params):
        missing, extra = sorted(set(params) - set(arrays)), sorted(set(arrays) - set(params))
        raise ValueError(f"parameter trees differ: missing {missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for name, param in params.items():
            array = arrays[name]
            if tuple(array.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {tuple(array.shape)} != {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(array, np.float32)).to(param.dtype))
    return model
