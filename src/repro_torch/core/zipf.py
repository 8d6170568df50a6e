"""Zipf-distributed request-trace generation (paper §2.3 workload).

The paper samples 12 traces of 100 000 requests per case, Zipf(alpha=1.1),
over N objects with N in [100, 100 000] (10 values, log-spaced) and cache-size
rates in [0.02, 0.25] (6 values, log-spaced) -- 60 cases total.

Object IDs are rank-ordered: id 0 is the most popular object (p_i ~ 1/(i+1)^a).
This matches the paper's rank-order plots and makes the PLFUA "hot set" the
id-prefix [0, hot_size).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

PAPER_ALPHA = 1.1
PAPER_TRACE_LEN = 100_000
PAPER_NUM_SAMPLES = 12


def zipf_probs(n_objects: int, alpha: float = PAPER_ALPHA) -> np.ndarray:
    """Normalized Zipf PMF over ranks 1..n (returned for ids 0..n-1)."""
    ranks = np.arange(1, n_objects + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


def sample_trace(
    n_objects: int,
    trace_len: int = PAPER_TRACE_LEN,
    alpha: float = PAPER_ALPHA,
    seed: int = 0,
) -> np.ndarray:
    """One Zipf(alpha) request trace; ids are popularity ranks (0 = hottest)."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(zipf_probs(n_objects, alpha))
    u = rng.random(trace_len)
    idx = np.searchsorted(cdf, u, side="right")
    # cumsum rounding can leave cdf[-1] a few ulps under 1.0; clamp the sliver
    return np.minimum(idx, n_objects - 1).astype(np.int32)


def sample_traces(
    n_objects: int,
    n_samples: int = PAPER_NUM_SAMPLES,
    trace_len: int = PAPER_TRACE_LEN,
    alpha: float = PAPER_ALPHA,
    seed: int = 0,
) -> np.ndarray:
    """(n_samples, trace_len) int32 — the paper's 12-sample replication."""
    return np.stack(
        [sample_trace(n_objects, trace_len, alpha, seed=seed * 7919 + i) for i in range(n_samples)]
    )


def paper_object_counts(num: int = 10, lo: int = 100, hi: int = 100_000) -> np.ndarray:
    """Object counts 'between 100 and 100,000 spaced evenly on log scale'.

    10 values: 100, 215, 464, 1000, 2154, 4641, 10000, 21544, 46415, 100000.
    (46415 appears verbatim in the paper's Fig. 4 discussion.)
    """
    return np.unique(np.round(np.logspace(np.log10(lo), np.log10(hi), num)).astype(int))


def paper_cache_rates(num: int = 6, lo: float = 0.02, hi: float = 0.25) -> np.ndarray:
    """Cache-size rates 'vary evenly on a log scale between 2 and 25%'.

    6 values: 0.02, 0.033, 0.055, 0.091, 0.151, 0.25 — the paper's §3.2 text
    cites rates 0.15 and 0.25, matching this spacing.
    """
    return np.logspace(np.log10(lo), np.log10(hi), num)


@dataclasses.dataclass(frozen=True)
class GridCase:
    """One of the paper's 60 (n_objects, cache rate) cases."""

    n_objects: int
    rate: float

    @property
    def cache_size(self) -> int:
        return max(1, int(round(self.n_objects * self.rate)))

    @property
    def hot_size(self) -> int:
        """PLFUA hot set: 'twice as many objects as the cache size' (paper §4)."""
        return min(self.n_objects, 2 * self.cache_size)


def paper_grid(
    object_counts: Sequence[int] | None = None,
    rates: Sequence[float] | None = None,
) -> list[GridCase]:
    counts = paper_object_counts() if object_counts is None else object_counts
    rates_ = paper_cache_rates() if rates is None else rates
    return [GridCase(int(n), float(r)) for n in counts for r in rates_]


# --- synthetic ISP-like trace (paper §2.1; the real trace is proprietary) ---

ISP_NUM_CHANNELS = 212
ISP_CACHE_SIZE = 50


def synthetic_isp_trace(
    trace_len: int = PAPER_TRACE_LEN,
    n_channels: int = ISP_NUM_CHANNELS,
    alpha: float = PAPER_ALPHA,
    seed: int = 2024,
) -> np.ndarray:
    """Rank-ordered channel-request trace with the paper's fitted Zipf(1.1) shape.

    212 channels / cache size 50 reproduce the paper's Fig. 2 setting. Session
    structure (start/stop times) is irrelevant to the cache policies, which see
    only the request sequence, so a plain Zipf trace is the faithful stand-in.
    """
    return sample_trace(n_channels, trace_len, alpha, seed=seed)
