"""Request traces and object sizes for this slice's path.

A copy of the reference package's ``workloads/generators.py``, bit for bit:
the six host scenarios (``stationary``, ``churn``, ``flash_crowd``,
``diurnal``, ``multi_tenant``, ``scan``), the tenant catalogue
``tenant_groups`` that matches ``multi_tenant``'s blocks, and the size
catalogue ``object_sizes``. ``tests/test_torch_workloads.py`` holds each to
the original.
Every trace is a fixed-shape ``(n_samples, trace_len)`` int32 array of object
ids in ``[0, n_objects)``, ids being initial-popularity ranks (id 0 is the
hottest), and drops straight into ``torch_cache`` and the cache_sim kernel.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import zipf

__all__ = [
    "stationary",
    "churn",
    "flash_crowd",
    "diurnal",
    "multi_tenant",
    "scan",
    "tenant_groups",
    "object_sizes",
    "SIZE_DISTS",
]

#: supported per-object size distributions (byte-capacity caches)
SIZE_DISTS = ("lognormal", "pareto")


def _rng(seed: int, sample: int) -> np.random.Generator:
    # same per-sample spreading constant as core.zipf.sample_traces
    return np.random.default_rng(seed * 7919 + sample)


def _sample_ranks(
    rng: np.random.Generator, n_objects: int, size: int, alpha: float
) -> np.ndarray:
    cdf = np.cumsum(zipf.zipf_probs(n_objects, alpha))
    idx = np.searchsorted(cdf, rng.random(size), side="right")
    # cumsum rounding can leave cdf[-1] a few ulps under 1.0; a draw in that
    # sliver would index past the id space
    return np.minimum(idx, n_objects - 1).astype(np.int32)


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


def churn(
    n_objects: int,
    n_samples: int = zipf.PAPER_NUM_SAMPLES,
    trace_len: int = zipf.PAPER_TRACE_LEN,
    *,
    alpha: float = zipf.PAPER_ALPHA,
    seed: int = 0,
    n_phases: int = 5,
    churn_frac: float = 0.3,
) -> np.ndarray:
    """Zipf with popularity churn: every ``trace_len/n_phases`` requests a
    random ``churn_frac`` of the id space swaps popularity ranks.

    Sampling stays rank-Zipf; a per-phase permutation maps rank -> object id,
    so across phases a fixed id's popularity jumps. Frequency policies that
    never forget (PLFU) and static admission (PLFUA) pay for stale metadata
    here; windowed policies (WLFU) shine.
    """
    if not 0.0 <= churn_frac <= 1.0:
        raise ValueError(f"churn_frac must be in [0, 1], got {churn_frac}")
    phase_len = max(1, -(-trace_len // max(1, n_phases)))
    out = np.empty((n_samples, trace_len), np.int32)
    k = int(round(churn_frac * n_objects))
    for s in range(n_samples):
        rng = _rng(seed, s)
        ranks = _sample_ranks(rng, n_objects, trace_len, alpha)
        perm = np.arange(n_objects, dtype=np.int32)
        for p, start in enumerate(range(0, trace_len, phase_len)):
            if p > 0 and k >= 2:
                moved = rng.choice(n_objects, size=k, replace=False)
                perm[moved] = perm[rng.permutation(moved)]
            stop = min(start + phase_len, trace_len)
            out[s, start:stop] = perm[ranks[start:stop]]
    return out

def flash_crowd(
    n_objects: int,
    n_samples: int = zipf.PAPER_NUM_SAMPLES,
    trace_len: int = zipf.PAPER_TRACE_LEN,
    *,
    alpha: float = zipf.PAPER_ALPHA,
    seed: int = 0,
    n_spikes: int = 3,
    spike_len_frac: float = 0.05,
    spike_intensity: float = 0.6,
) -> np.ndarray:
    """Stationary Zipf punctured by flash crowds: in each spike window a
    previously-cold object (drawn from the coldest quartile) takes
    ``spike_intensity`` of the request mass — a breaking-news/viral-video
    event no prior-popularity hot set anticipates.
    """
    base = stationary(
        n_objects, n_samples, trace_len, alpha=alpha, seed=seed
    ).copy()
    spike_len = max(1, int(round(spike_len_frac * trace_len)))
    cold_lo = max(1, (3 * n_objects) // 4)
    for s in range(n_samples):
        rng = _rng(seed + 104_729, s)
        population = max(1, trace_len - spike_len)
        starts = rng.choice(population, size=min(n_spikes, population), replace=False)
        for start in np.sort(starts):
            hot_id = int(rng.integers(cold_lo, n_objects))
            window = slice(start, min(start + spike_len, trace_len))
            mask = rng.random(base[s, window].shape[0]) < spike_intensity
            base[s, window][mask] = hot_id
    return base

def diurnal(
    n_objects: int,
    n_samples: int = zipf.PAPER_NUM_SAMPLES,
    trace_len: int = zipf.PAPER_TRACE_LEN,
    *,
    alpha: float = zipf.PAPER_ALPHA,
    seed: int = 0,
    n_cycles: int = 2,
    alpha_swing: float = 0.5,
    n_chunks: int = 48,
) -> np.ndarray:
    """Diurnal cycle as skew modulation. The trace shape is fixed (unit
    request rate), so the day/night cycle appears as the Zipf exponent
    swinging sinusoidally in ``[alpha - swing, alpha + swing]``: peak hours
    concentrate on head content (high alpha), off-hours flatten the tail —
    which sweeps the *effective* working-set size the cache must hold.
    """
    out = np.empty((n_samples, trace_len), np.int32)
    bounds = np.linspace(0, trace_len, n_chunks + 1).astype(int)
    mid = 0.5 * (bounds[:-1] + bounds[1:]) / trace_len
    alphas = alpha + alpha_swing * np.sin(2 * np.pi * n_cycles * mid)
    alphas = np.maximum(alphas, 0.05)
    for s in range(n_samples):
        rng = _rng(seed + 224_737, s)
        for (a, lo, hi) in zip(alphas, bounds[:-1], bounds[1:]):
            if hi > lo:
                out[s, lo:hi] = _sample_ranks(rng, n_objects, hi - lo, float(a))
    return out


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


def multi_tenant(
    n_objects: int,
    n_samples: int = zipf.PAPER_NUM_SAMPLES,
    trace_len: int = zipf.PAPER_TRACE_LEN,
    *,
    alpha: float = zipf.PAPER_ALPHA,
    seed: int = 0,
    n_tenants: int = 4,
    weights: tuple[float, ...] | None = None,
) -> np.ndarray:
    """K tenants share the fleet: the id space splits into contiguous blocks,
    each tenant runs its own Zipf(alpha) over its block, and requests draw a
    tenant by fixed mixture weight (default: Zipf over tenants, so one tenant
    dominates). Object id = block offset + within-tenant rank: every tenant
    has its own head, so a single global rank-prefix hot set misallocates.
    """
    if n_tenants < 1 or n_tenants > n_objects:
        raise ValueError(f"need 1 <= n_tenants <= n_objects, got {n_tenants}")
    if weights is None:
        w = zipf.zipf_probs(n_tenants, 1.0)
    else:
        if len(weights) != n_tenants:
            raise ValueError("len(weights) must equal n_tenants")
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
    block = n_objects // n_tenants
    sizes = np.full(n_tenants, block, np.int64)
    sizes[: n_objects - block * n_tenants] += 1  # distribute the remainder
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    out = np.empty((n_samples, trace_len), np.int32)
    for s in range(n_samples):
        rng = _rng(seed + 350_377, s)
        tenant = rng.choice(n_tenants, size=trace_len, p=w)
        for t in range(n_tenants):
            mask = tenant == t
            cnt = int(mask.sum())
            if cnt:
                out[s, mask] = offsets[t] + _sample_ranks(rng, int(sizes[t]), cnt, alpha)
    return out


def tenant_groups(n_objects: int, n_tenants: int = 4) -> np.ndarray:
    """The id -> tenant catalogue matching :func:`multi_tenant`'s block map:
    object id ``i`` belongs to the tenant whose contiguous block contains it
    (same block sizes, same remainder distribution). ``(n_objects,)`` int32
    in ``[0, n_tenants)`` — the ``groups`` argument of the group-segmented
    telemetry tiers (``TelemetrySpec(window, n_groups=n_tenants)``)."""
    if n_tenants < 1 or n_tenants > n_objects:
        raise ValueError(f"need 1 <= n_tenants <= n_objects, got {n_tenants}")
    block = n_objects // n_tenants
    sizes = np.full(n_tenants, block, np.int64)
    sizes[: n_objects - block * n_tenants] += 1  # distribute the remainder
    return np.repeat(np.arange(n_tenants, dtype=np.int32), sizes)
