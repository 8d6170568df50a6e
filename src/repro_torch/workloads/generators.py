"""Request traces and object sizes for this slice's path.

A copy of the reference package's ``workloads/generators.py`` functions that
the port runs (``stationary``, ``scan``, ``object_sizes`` and their helper),
bit for bit: ``tests/test_torch_workloads.py`` holds each to the original.
Every trace is a fixed-shape ``(n_samples, trace_len)`` int32 array of object
ids in ``[0, n_objects)``, ids being initial-popularity ranks (id 0 is the
hottest), and drops straight into ``torch_cache`` and the cache_sim kernel.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import zipf

__all__ = ["SIZE_DISTS", "object_sizes", "scan", "stationary"]

#: supported per-object size distributions (byte-capacity caches)
SIZE_DISTS = ("lognormal", "pareto")


def _rng(seed: int, sample: int) -> np.random.Generator:
    # same per-sample spreading constant as core.zipf.sample_traces
    return np.random.default_rng(seed * 7919 + sample)


def stationary(
    n_objects: int,
    n_samples: int = zipf.PAPER_NUM_SAMPLES,
    trace_len: int = zipf.PAPER_TRACE_LEN,
    *,
    alpha: float = zipf.PAPER_ALPHA,
    seed: int = 0,
) -> np.ndarray:
    """The paper's workload: i.i.d. Zipf(alpha), ids = popularity ranks."""
    return zipf.sample_traces(
        n_objects, n_samples=n_samples, trace_len=trace_len, alpha=alpha, seed=seed
    )


def scan(
    n_objects: int,
    n_samples: int = zipf.PAPER_NUM_SAMPLES,
    trace_len: int = zipf.PAPER_TRACE_LEN,
    *,
    alpha: float = zipf.PAPER_ALPHA,
    seed: int = 0,
    n_sweeps: int = 4,
    sweep_len_frac: float = 0.05,
    sweep_intensity: float = 0.8,
    scan_lo_frac: float = 0.5,
) -> np.ndarray:
    """Stationary Zipf punctured by sequential one-touch sweeps — the classic
    adversary of recency- and frequency-based eviction (a crawler / backup /
    prefetcher walking the catalogue).

    ``n_sweeps`` fixed windows of ``sweep_len_frac * trace_len`` requests are
    placed at the centres of equal trace segments; inside a window each
    position is overwritten with probability ``sweep_intensity`` by the next
    id of a sequential walk over ``[scan_lo_frac * n_objects, n_objects)``
    (a per-sample random start offset, the walk position carried across
    sweeps). As long as the total overwritten count stays below the scan
    region, every swept id is touched exactly once per pass; repeated sweeps
    re-walk the same region — re-crawls the cache gains nothing by storing.

    LRU flushes its whole working set per sweep; in-memory LFU churns its
    freq-1 tail (and restarts evicted metadata at 1, so every re-sweep churns
    it again); ARC funnels the one-touch ids through T1 while the
    re-referenced working set survives in T2.
    """
    if n_sweeps < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")
    if not 0.0 <= sweep_intensity <= 1.0:
        raise ValueError(f"sweep_intensity must be in [0, 1], got {sweep_intensity}")
    if not 0.0 <= scan_lo_frac < 1.0:
        raise ValueError(f"scan_lo_frac must be in [0, 1), got {scan_lo_frac}")
    base = stationary(n_objects, n_samples, trace_len, alpha=alpha, seed=seed).copy()
    if n_sweeps == 0:
        return base
    sweep_len = max(1, int(round(sweep_len_frac * trace_len)))
    scan_lo = int(round(scan_lo_frac * n_objects))
    span = n_objects - scan_lo
    in_sweep = np.zeros(trace_len, bool)
    seg = trace_len // n_sweeps
    for i in range(n_sweeps):
        start = i * seg + max(0, (seg - sweep_len) // 2)
        in_sweep[start : start + sweep_len] = True
    for s in range(n_samples):
        rng = _rng(seed + 611_657, s)
        take = in_sweep & (rng.random(trace_len) < sweep_intensity)
        offset = int(rng.integers(0, span))
        k = np.cumsum(take) - 1  # walk position at each swept slot
        base[s, take] = scan_lo + (offset + k[take]) % span
    return base


def object_sizes(
    n_objects: int,
    *,
    dist: str = "lognormal",
    corr: float = 0.0,
    seed: int = 0,
    median: int = 64,
    sigma: float = 1.2,
    shape: float = 1.5,
    max_size: int = 1 << 20,
) -> np.ndarray:
    """Heavy-tailed per-object byte sizes, ``(n_objects,)`` int32 ``>= 1``.

    The companion of the trace generators for byte-capacity tiers
    (``PolicySpec.capacity_bytes``): index ``i`` is object id ``i``'s size,
    the parallel axis of the fixed-shape int32 trace contract. Two classic
    web-object families: ``lognormal`` (body) and ``pareto`` (tail), both
    scaled so ``median`` is the distribution's median and clipped to
    ``[1, max_size]``.

    ``corr`` in [-1, 1] is the size–popularity correlation knob (ids are
    popularity ranks): ``+1`` assigns the largest sizes to the hottest ids,
    ``-1`` to the coldest, ``0`` independently; intermediate values mix a
    rank key with uniform noise, so |corr| acts as a rank-correlation
    strength. The drawn multiset of sizes is identical for every ``corr``,
    only the assignment changes — byte-CHR comparisons across ``corr`` see
    the same total catalogue bytes.
    """
    if dist not in SIZE_DISTS:
        raise ValueError(f"unknown size dist {dist!r}; expected one of {SIZE_DISTS}")
    if not -1.0 <= corr <= 1.0:
        raise ValueError(f"corr must be in [-1, 1], got {corr}")
    rng = np.random.default_rng(seed * 7919 + 611_953)
    if dist == "lognormal":
        raw = median * np.exp(sigma * rng.standard_normal(n_objects))
    else:  # pareto: median * 2**(1/shape) quantile trick keeps median exact
        raw = median * (1.0 + rng.pareto(shape, n_objects)) / (2.0 ** (1.0 / shape))
    raw = np.clip(np.rint(raw), 1, max_size).astype(np.int32)
    if corr:
        ids = np.arange(n_objects, dtype=np.float64)
        keyv = corr * ids / max(1, n_objects - 1) + (1.0 - abs(corr)) * rng.random(
            n_objects
        )
        order = np.argsort(keyv, kind="stable")  # ascending key gets largest
        out = np.empty_like(raw)
        out[order] = np.sort(raw)[::-1]
        raw = out
    return raw
