"""Per-tier service-time model → per-tenant latency SLOs.

The port's copy of the reference package's latency model.

Under a fixed per-tier service time the *serving level* of a request is a
complete latency description: a request served at topology level ``l``
costs ``service_us[l]``, a fleet-wide miss costs ``origin_us``. Both fleet
engines route each request to its lowest hitting level (level-major by
demand routing, the placed engine by its bottom-up probe), so the grouped
per-level ``hits`` counters the telemetry scans accumulate *in-scan* are
already a fixed-bucket latency histogram per group — buckets = serving
levels + origin, no extra scan state — and p50/p99 are exact discrete
inverse-CDF reads over those buckets, not sampled estimates.

Everything here is host-side numpy over the (small) windowed series.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def percentile_us(counts, values_us, q: float) -> float:
    """Discrete inverse CDF: the smallest value whose cumulative count
    reaches ``q`` of the total. Empty histograms report 0.0."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    c = np.asarray(counts, dtype=np.float64)
    v = np.asarray(values_us, dtype=np.float64)
    if c.shape != v.shape:
        raise ValueError(f"counts {c.shape} != values {v.shape}")
    order = np.argsort(v, kind="stable")
    v, c = v[order], c[order]
    total = float(c.sum())
    if total <= 0:
        return 0.0
    cum = np.cumsum(c)
    idx = int(np.searchsorted(cum, q * total, side="left"))
    return float(v[min(idx, len(v) - 1)])


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Fixed hit service time per topology level (edge first) plus the
    origin fetch time for fleet-wide misses: p50/p99 beside energy."""

    service_us: tuple[float, ...]
    origin_us: float

    def __post_init__(self):
        if len(self.service_us) < 1:
            raise ValueError("need at least one level service time")
        if any(s <= 0 for s in self.service_us) or self.origin_us <= 0:
            raise ValueError("service times must be positive")

    @classmethod
    def default(cls, n_levels: int) -> "LatencyModel":
        """A deterministic 5x-per-hop ladder: 1 ms at the edge, 5 ms one
        level up, ..., origin one hop past the deepest tier."""
        return cls(
            service_us=tuple(1_000.0 * 5.0**l for l in range(n_levels)),
            origin_us=1_000.0 * 5.0**n_levels,
        )

    @property
    def n_levels(self) -> int:
        return len(self.service_us)

    @property
    def bucket_us(self) -> tuple[float, ...]:
        """Histogram bucket latencies: one per serving level + origin."""
        return self.service_us + (self.origin_us,)

    def histogram(self, level_hits, origin_counts) -> np.ndarray:
        """Stack per-level serve counts (n_levels, ...) with the origin
        remainder (...) into the (n_levels + 1, ...) bucket-count layout
        aligned with :attr:`bucket_us`."""
        lh = np.asarray(level_hits)
        if lh.shape[0] != self.n_levels:
            raise ValueError(
                f"level_hits has {lh.shape[0]} levels, model has {self.n_levels}"
            )
        return np.concatenate([lh, np.asarray(origin_counts)[None, ...]], axis=0)

    def percentile(self, bucket_counts, q: float) -> float:
        """p-quantile latency of one (n_levels + 1,) bucket histogram."""
        return percentile_us(bucket_counts, self.bucket_us, q)

    def mean_us(self, bucket_counts) -> float:
        """Request-weighted mean latency of one bucket histogram."""
        c = np.asarray(bucket_counts, dtype=np.float64)
        total = float(c.sum())
        if total <= 0:
            return 0.0
        return float((c * np.asarray(self.bucket_us)).sum() / total)
