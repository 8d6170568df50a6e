"""Cross-tier placement policies: where a missed object is re-inserted.

The port's numpy copy of the reference package's placement module. When a
request misses at level ``l`` and is served at some level ``s > l`` (or at the
origin), every consulted tier below ``s`` sees the object travel back down the
fill path; *placement* decides which of them store a copy:

  * ``lce``      — leave-copy-everywhere: every consulted tier inserts
                   (subject to its own policy admission). The default.
  * ``lcd``      — leave-copy-down: only the tier directly below the serving
                   tier inserts, so objects descend one level per request.
  * ``prob(p)``  — the tier directly below the server always fills, every
                   other consulted tier with probability ``p``; the coin is a
                   lowbias32 hash of (trace position, level).
  * ``admit``    — sketch-gated: a count-min sketch per node; a miss fills
                   only when the cache has room or the object's estimate beats
                   the current victim's.

Placement gates insertion only: a tier's policy metadata still sees every
consulted request. The level-major fleet engine runs all-``lce`` topologies,
the time-major placed engine every other one; the placed engine draws the
``prob(p)`` coins of a whole call at once (:func:`coin_table`, on torch
tensors), the pure-Python oracle (:mod:`repro_torch.fleet.reference`) and the
serving front one at a time on the host, bit-identical.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.core import sketch

__all__ = [
    "PLACEMENT_KINDS",
    "parse",
    "validate",
    "prob_fill",
    "fill_hash_u32",
    "coin_table",
    "admit_params",
]

#: base placement kinds; ``prob`` takes a parameter, spelled ``prob(p)``.
PLACEMENT_KINDS = ("lce", "lcd", "prob", "admit")

_PROB_RE = re.compile(r"^prob\(([0-9.eE+-]+)\)$")

#: salt constants decorrelating the placement coin from every other lowbias32
#: use in the repo (sketch buckets, bloom bits, routers).
_T_SALT = 0x2545F491
_LEVEL_SALT = 0x9E3779B9
_U32 = 0xFFFFFFFF


def _level_salt(level: int) -> int:
    return ((level + 1) * _LEVEL_SALT) & _U32


def parse(spec: str) -> tuple[str, float | None]:
    """``"lce" | "lcd" | "admit" | "prob(p)"`` -> ``(kind, p-or-None)``."""
    if not isinstance(spec, str):
        raise ValueError(f"placement must be a string, got {spec!r}")
    if spec in ("lce", "lcd", "admit"):
        return spec, None
    m = _PROB_RE.match(spec)
    if m:
        try:
            p = float(m.group(1))
        except ValueError:
            p = None
        if p is not None and 0.0 <= p <= 1.0:
            return "prob", p
        raise ValueError(f"prob placement needs p in [0, 1], got {spec!r}")
    raise ValueError(
        f"unknown placement {spec!r}; expected one of "
        f"'lce', 'lcd', 'admit', or 'prob(p)' with p in [0, 1]"
    )


def validate(spec: str) -> str:
    """Parse for effect; returns the spec unchanged (Topology validation)."""
    parse(spec)
    return spec


def fill_hash_u32(t, level: int):
    """Deterministic uint32 coin for the ``prob(p)`` placement at trace
    position ``t`` (a scalar, an array or a torch tensor), level ``level``:
    uint32 lowbias32 arithmetic, identical across processes and platforms. A
    tensor gives int64 values in ``[0, 2**32)`` on its device (torch's uint32
    arithmetic is incomplete, so it computes in int64 masked to 32 bits, as
    :func:`repro_torch.cdn.router.route_level` does), bit for bit numpy's."""
    if isinstance(t, torch.Tensor):
        key = (sketch._mul32((t.to(torch.int64) + 1) & _U32, _T_SALT)) ^ _level_salt(level)
        return sketch._mix32_i64(key)
    u = np.uint32
    t_arr = np.asarray(t, np.uint32)
    scalar = t_arr.ndim == 0
    if scalar:
        t_arr = t_arr.reshape(1)  # array ops wrap silently; scalar ops warn
    key = (t_arr + u(1)) * u(_T_SALT)
    key = key ^ u(_level_salt(level))
    mixed = sketch._mix32(key)
    return mixed[0] if scalar else mixed


def _threshold(p: float) -> int:
    return int(round(float(p) * 4294967296.0))  # p * 2**32


def prob_fill(t, level: int, p: float):
    """The ``prob(p)`` coin: True where the hash falls below ``p``'s
    threshold; ``p >= 1`` is constant True (== lce) and ``p <= 0`` constant
    False (== lcd's floor only)."""
    thr = _threshold(p)
    shape = np.shape(np.asarray(t))
    if thr >= 1 << 32:
        return np.ones(shape, bool) if shape else np.asarray(True)
    if thr <= 0:
        return np.zeros(shape, bool) if shape else np.asarray(False)
    return fill_hash_u32(t, level) < np.uint32(thr)


def coin_table(placements, n_positions: int, device, start: int = 0) -> torch.Tensor | None:
    """Every ``prob(p)`` coin of a call: ``(L, n_positions)`` bool on
    ``device``, row ``l`` the coins of level ``l`` at positions ``start ..
    start + n_positions - 1`` (:func:`prob_fill`'s; a stream chunk starts at
    its global position), or ``None`` when no level draws one. Levels of another placement, and the constant ends ``p >= 1``
    and ``p <= 0``, which the placed engine keeps as constants, get rows of
    False."""
    parsed = [parse(p) for p in placements]
    drawn = [l for l, (kind, p) in enumerate(parsed) if kind == "prob" and 0 < _threshold(p) < 1 << 32]
    if not drawn:
        return None
    t = torch.arange(start, start + n_positions, dtype=torch.int64, device=device)
    table = torch.zeros((len(parsed), n_positions), dtype=torch.bool, device=device)
    for l in drawn:
        table[l] = fill_hash_u32(t, l) < _threshold(parsed[l][1])
    return table


def admit_params(level_specs) -> tuple[int, int]:
    """(sketch width, aging window) of one level's *placement* sketch, from
    the level's first node by TinyLFU's capacity conventions."""
    cap = level_specs[0].capacity
    return sketch.default_width(cap), sketch.default_window(cap)
