"""Count-min sketch conventions that ``PolicySpec.effective_*`` read.

Only the shape constants and default sizes live here for now. The hashing
(lowbias32 bucket and bloom tables) and the row operations come with the
sketch kinds (ROADMAP module 1, queue 2.1.4).
"""
from __future__ import annotations

__all__ = [
    "DEPTH",
    "default_doorkeeper",
    "default_refresh",
    "default_width",
    "default_window",
]

#: number of sketch rows (independent hash functions); fixed, not a knob, so
#: every tier agrees on the state shape without threading another parameter.
DEPTH = 4


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
