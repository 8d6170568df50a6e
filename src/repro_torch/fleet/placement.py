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
consulted request. The level-major fleet engine runs all-``lce`` topologies;
the placed engine (ROADMAP.md module 8) is not ported yet, and with it the
torch form of the placement hash. The pure-Python oracle
(:mod:`repro_torch.fleet.reference`) uses this module on the host.
"""
from __future__ import annotations

import re

import numpy as np

from repro_torch.core import sketch

__all__ = [
    "PLACEMENT_KINDS",
    "parse",
    "validate",
    "prob_fill",
    "fill_hash_u32",
    "admit_params",
]

#: base placement kinds; ``prob`` takes a parameter, spelled ``prob(p)``.
PLACEMENT_KINDS = ("lce", "lcd", "prob", "admit")

_PROB_RE = re.compile(r"^prob\(([0-9.eE+-]+)\)$")

#: salt constants decorrelating the placement coin from every other lowbias32
#: use in the repo (sketch buckets, bloom bits, routers).
_T_SALT = 0x2545F491
_LEVEL_SALT = 0x9E3779B9


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
    position ``t`` (a scalar or an array), level ``level``: uint32 lowbias32
    arithmetic, identical across processes and platforms."""
    u = np.uint32
    t_arr = np.asarray(t, np.uint32)
    scalar = t_arr.ndim == 0
    if scalar:
        t_arr = t_arr.reshape(1)  # array ops wrap silently; scalar ops warn
    level_salt = ((level + 1) * _LEVEL_SALT) & 0xFFFFFFFF
    key = (t_arr + u(1)) * u(_T_SALT)
    key = key ^ u(level_salt)
    mixed = sketch._mix32(key)
    return mixed[0] if scalar else mixed


def prob_fill(t, level: int, p: float):
    """The ``prob(p)`` coin: True where the hash falls below ``p``'s
    threshold; ``p >= 1`` is constant True (== lce) and ``p <= 0`` constant
    False (== lcd's floor only)."""
    thr = int(round(float(p) * 4294967296.0))  # p * 2**32
    shape = np.shape(np.asarray(t))
    if thr >= 1 << 32:
        return np.ones(shape, bool) if shape else np.asarray(True)
    if thr <= 0:
        return np.zeros(shape, bool) if shape else np.asarray(False)
    return fill_hash_u32(t, level) < np.uint32(thr)


def admit_params(level_specs) -> tuple[int, int]:
    """(sketch width, aging window) of one level's *placement* sketch, from
    the level's first node by TinyLFU's capacity conventions."""
    cap = level_specs[0].capacity
    return sketch.default_width(cap), sketch.default_window(cap)
