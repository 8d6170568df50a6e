"""Count-min sketch: hashing tables, row operations and size conventions.

A copy of the reference package's sketch module, so the port imports nothing
of it. ``DEPTH`` rows of ``width`` int32 counters; every request increments
one counter per row, an estimate is the min over rows, and halving ("aging")
keeps the counts recency-weighted. The doorkeeper is a ``BLOOM_DEPTH``-hash
bloom filter in front of the sketch.

The hash is lowbias32 on salted ids, in uint32 arithmetic. The tables are
computed host-side in numpy uint32, whose products wrap exactly as the
reference's do, so nothing is emulated and nothing overflows; the CUDA
kernels compute the same indices from the id in ``uint32_t``.

``CountMinSketch`` and ``BloomFilter`` are the stateful numpy versions the
pure-Python reference policies (:mod:`repro_torch.core.policies`) use.

The row operations act on batched torch tensors: ``rows`` is ``(S, DEPTH,
W)`` int32, a bloom is ``(S, M)`` bool, and index arguments are ``(S,
DEPTH)`` / ``(S, BLOOM_DEPTH)`` (one request per sample). The updates are in
place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import arange

__all__ = [
    "BLOOM_DEPTH",
    "BloomFilter",
    "CountMinSketch",
    "DEPTH",
    "bloom_contains",
    "bloom_set",
    "bloom_table",
    "bucket_table",
    "default_doorkeeper",
    "default_refresh",
    "default_width",
    "default_window",
    "rows_add",
    "rows_estimate",
    "rows_estimate_all",
    "rows_halve",
]

#: number of sketch rows (independent hash functions); fixed, not a knob, so
#: every tier agrees on the state shape without threading another parameter.
DEPTH = 4

#: per-row salts (arbitrary odd mixing constants, one per hash function).
_SALTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)

#: doorkeeper bloom filter: independent hash functions (and salts disjoint
#: from the sketch rows', so bloom bits and sketch buckets decorrelate).
BLOOM_DEPTH = 2
_BLOOM_SALTS = (0xB5297A4D, 0x68E31DA4)


def default_width(capacity: int) -> int:
    """Sketch width convention: 4x cache size, floored at 256 counters."""
    return max(4 * int(capacity), 256)


def default_window(capacity: int) -> int:
    """TinyLFU aging window convention: 10x cache size, floored at 1000."""
    return max(10 * int(capacity), 1000)


def default_refresh(capacity: int) -> int:
    """Dynamic-PLFUA hot-set refresh convention (same shape as the window)."""
    return max(10 * int(capacity), 1000)


def default_doorkeeper(capacity: int) -> int:
    """Doorkeeper bloom size convention: 8 bits per cached object, floored at
    512 bits."""
    return max(8 * int(capacity), 512)


# ------------------------------------------------------------------- hashing
def _mix32(h: np.ndarray) -> np.ndarray:
    """lowbias32 integer finalizer (hash-prospector constants) on a uint32
    array; numpy's uint32 products wrap mod 2**32."""
    u = np.uint32
    h = h ^ (h >> u(16))
    h = h * u(0x7FEB352D)
    h = h ^ (h >> u(15))
    h = h * u(0x846CA68B)
    h = h ^ (h >> u(16))
    return h


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in ``[0, 2**32)``, in two 16-bit
    halves of ``c`` so that no product leaves int64's range."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _mix32_i64(h: torch.Tensor) -> torch.Tensor:
    """:func:`_mix32` on torch tensors, whose uint32 arithmetic is incomplete:
    ``h`` is int64 with values in ``[0, 2**32)``, and so is the result, bit for
    bit numpy's uint32 finalizer."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _salted_table(ids, salts, modulus: int) -> np.ndarray:
    ids = np.asarray(ids, np.uint32)
    h = _mix32((ids[..., None] + np.uint32(1)) * np.asarray(salts, np.uint32))
    return (h % np.uint32(modulus)).astype(np.int32)


def bucket_table(ids, width: int) -> np.ndarray:
    """Bucket indices for ``ids``: shape ``ids.shape + (DEPTH,)`` int32."""
    return _salted_table(ids, _SALTS, width)


def bloom_table(ids, m_bits: int) -> np.ndarray:
    """Doorkeeper bit indices for ``ids``: shape ``ids.shape + (BLOOM_DEPTH,)``
    int32, the same arithmetic as :func:`bucket_table` under the bloom salts."""
    return _salted_table(ids, _BLOOM_SALTS, m_bits)


# ------------------------------------------------------------ row operations
def _samples(t: torch.Tensor) -> torch.Tensor:
    return arange(t.shape[0], t.device)[:, None]


def rows_add(rows: torch.Tensor, idx: torch.Tensor, inc=True) -> None:
    """``rows[s, d, idx[s, d]] += inc[s]`` for every row ``d`` (``inc``: a
    bool or an ``(S,)`` bool tensor)."""
    d = arange(rows.shape[1], rows.device)
    rows[_samples(rows), d, idx] += inc[:, None] if isinstance(inc, torch.Tensor) else int(inc)


def rows_estimate(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Point estimates ``(S,)``: min over rows of the addressed counters."""
    return rows[_samples(rows), arange(rows.shape[1], rows.device), idx].amin(dim=-1)


def rows_estimate_all(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Estimates ``(S, N)`` of every id; ``table`` is ``(N, DEPTH)`` from
    :func:`bucket_table`."""
    return rows[:, arange(rows.shape[1], rows.device), table].amin(dim=-1)


def rows_halve(rows: torch.Tensor) -> None:
    """Aging: halve every counter (floor division by 2)."""
    rows >>= 1


def bloom_set(bits: torch.Tensor, bidx: torch.Tensor) -> None:
    """Set the ``BLOOM_DEPTH`` bits addressed by ``bidx`` in every sample."""
    bits[_samples(bits), bidx] = True


def bloom_contains(bits: torch.Tensor, bidx: torch.Tensor) -> torch.Tensor:
    """Membership ``(S,)``: all addressed bits set."""
    return bits[_samples(bits), bidx].all(dim=-1)


# --------------------------------------------------------- numpy convenience
class CountMinSketch:
    """Stateful numpy sketch used by the pure-Python reference policies."""

    depth = DEPTH

    def __init__(self, width: int):
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        self.width = int(width)
        self.rows = np.zeros((DEPTH, self.width), dtype=np.int32)

    def _idx(self, x: int) -> np.ndarray:
        return bucket_table(np.asarray(x), self.width)

    def add(self, x: int) -> None:
        self.rows[np.arange(DEPTH), self._idx(x)] += 1

    def estimate(self, x: int) -> int:
        return int(self.rows[np.arange(DEPTH), self._idx(x)].min())

    def estimate_all(self, n_objects: int) -> np.ndarray:
        """(n_objects,) estimates — the dynamic-PLFUA refresh input."""
        table = bucket_table(np.arange(n_objects), self.width)
        return self.rows[np.arange(DEPTH), table].min(axis=-1)

    def halve(self) -> None:
        self.rows >>= 1


class BloomFilter:
    """Stateful numpy doorkeeper used by the pure-Python reference policies:
    a plain ``(m_bits,)`` bool array, the layout the simulators carry."""

    depth = BLOOM_DEPTH

    def __init__(self, m_bits: int):
        if m_bits < 1:
            raise ValueError(f"m_bits must be >= 1, got {m_bits}")
        self.m_bits = int(m_bits)
        self.bits = np.zeros((self.m_bits,), dtype=bool)

    def _idx(self, x: int) -> np.ndarray:
        return bloom_table(np.asarray(x), self.m_bits)

    def add(self, x: int) -> None:
        self.bits[self._idx(x)] = True

    def contains(self, x: int) -> bool:
        return bool(self.bits[self._idx(x)].all())

    def clear(self) -> None:
        self.bits[:] = False
