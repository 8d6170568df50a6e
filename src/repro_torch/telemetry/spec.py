"""Windowed-telemetry spec and series assembly, on torch tensors.

The port's copy of the reference package's ``telemetry/spec.py``. A run
instrumented with :class:`TelemetrySpec(window=W)` returns an int32 series
shaped ``[..., n_windows, N_METRICS]`` where ``n_windows = ceil(T / W)`` (the
last window may be partial) and the metric axis is :data:`METRICS`, in order:

``requests``     trace positions of the window
``hits``         requests served from the cache
``misses``       ``requests - hits``
``fills``        objects inserted (misses that actually stored)
``evictions``    objects evicted to make room for a fill (byte mode: every
                 victim of one insert)
``fill_offers``  misses offered to the cache (a flat cache: every miss)
``occupancy``    cached-object count at the *end* of the window (the partial
                 tail window reports the value after the last request)
``refreshes``    tinylfu aging resets and plfua_dyn hot-set refreshes, in
                 the window of the request that completed the period
``hot_churn``    plfua_dyn only: the size of the symmetric difference of the
                 hot masks before and after each refresh
``hit_bytes``    bytes served from the cache (unit sizes: ``== hits``)
``miss_bytes``   bytes fetched past the cache (unit sizes: ``== misses``)

With ``n_groups=G`` and an id -> group catalogue (ids in ``[0, G)``) the
series becomes ``[..., n_windows, G, N_METRICS]``: request metrics land in
the requester's group, evictions in each victim's group, occupancy and hot
churn are per-group membership counts. Summing over the group axis gives the
ungrouped series exactly.

Every builder takes and returns torch tensors on the inputs' device. Sums
are taken in int64 and wrapped to int32, as the reference's int32 sums wrap.
Nothing here uses an integer matrix product (the card has none).
"""
from __future__ import annotations

import dataclasses

import torch

METRICS = (
    "requests",
    "hits",
    "misses",
    "fills",
    "evictions",
    "fill_offers",
    "occupancy",
    "refreshes",
    "hot_churn",
    "hit_bytes",
    "miss_bytes",
)
N_METRICS = len(METRICS)
METRIC_INDEX = {name: i for i, name in enumerate(METRICS)}

__all__ = [
    "METRICS", "N_METRICS", "METRIC_INDEX", "TelemetrySpec", "n_windows", "window_sizes", "bucket_sum",
    "bucket_end", "chunk_window_matrix", "series_from_run", "group_onehot", "grouped_series_from_run",
    "windowed_pressure",
]


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """The window length and the number of tenant groups (0 = ungrouped)."""

    window: int
    n_groups: int = 0

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"telemetry window must be >= 1, got {self.window}")
        if self.n_groups < 0:
            raise ValueError(f"n_groups must be >= 0, got {self.n_groups}")

    def n_windows(self, trace_len: int) -> int:
        return n_windows(trace_len, self.window)


def n_windows(trace_len: int, window: int) -> int:
    """ceil(T / W): the fixed window count of a run."""
    if trace_len < 1:
        raise ValueError(f"trace_len must be >= 1, got {trace_len}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return -(-trace_len // window)


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32, as an int32 sum wraps."""
    return ((v.to(torch.int64) + 2**31) % 2**32 - 2**31).to(torch.int32)


def window_sizes(trace_len: int, window: int, device=None) -> torch.Tensor:
    """(n_windows,) int32: trace positions per window (the tail may be partial)."""
    nw = n_windows(trace_len, window)
    sizes = torch.full((nw,), window, dtype=torch.int32, device=device)
    sizes[-1] = trace_len - (nw - 1) * window
    return sizes


def bucket_sum(series: torch.Tensor, window: int) -> torch.Tensor:
    """(..., T) -> (..., n_windows) int32 per-window sums (zero-padded tail)."""
    s = torch.as_tensor(series).to(torch.int64)
    t = s.shape[-1]
    nw = n_windows(t, window)
    pad = nw * window - t
    if pad:
        s = torch.cat([s, s.new_zeros(s.shape[:-1] + (pad,))], dim=-1)
    return _wrap_i32(s.reshape(s.shape[:-1] + (nw, window)).sum(dim=-1))


def bucket_end(series: torch.Tensor, window: int) -> torch.Tensor:
    """(..., T) -> (..., n_windows) int32 values at each window's last step;
    a partial last window reports the value at the last real step."""
    s = torch.as_tensor(series)
    t = s.shape[-1]
    nw = n_windows(t, window)
    ends = torch.clamp(torch.arange(1, nw + 1, device=s.device) * window - 1, max=t - 1)
    return s[..., ends].to(torch.int32)


def chunk_window_matrix(n_chunks: int, chunk_len: int, trace_len: int, window: int, device=None) -> torch.Tensor:
    """(n_chunks, n_windows) int32 map of chunk-boundary events (plfua_dyn
    refreshes) to windows: the event at the end of chunk ``c`` belongs to
    the window of trace position ``(c+1)*chunk_len - 1``, clamped to the
    trace (a padded tail chunk never fires)."""
    nw = n_windows(trace_len, window)
    pos = torch.clamp((torch.arange(n_chunks, device=device) + 1) * chunk_len - 1, max=trace_len - 1)
    m = torch.zeros((n_chunks, nw), dtype=torch.int32, device=device)
    m[torch.arange(n_chunks, device=device), pos // window] = 1
    return m


def _chunks_to_windows(events: torch.Tensor, m: torch.Tensor, grouped: bool) -> torch.Tensor:
    """(..., C) x (C, W) -> (..., W), or (..., C, G) x (C, W) -> (..., W, G),
    as an int64 broadcast sum (exact on every device)."""
    e = events.to(torch.int64)
    m = m.to(torch.int64)
    if grouped:
        return (e.unsqueeze(-2) * m.unsqueeze(-1)).sum(dim=-3)
    return (e.unsqueeze(-1) * m).sum(dim=-2)


def series_from_run(
    window: int,
    trace_len: int,
    *,
    hits,
    fills,
    evictions,
    occupancy,
    active=None,
    offers=None,
    aging=None,
    fired=None,
    churn=None,
    hit_bytes=None,
    miss_bytes=None,
    chunk_len: int | None = None,
) -> torch.Tensor:
    """Bucket per-step event series (..., T) into ``[..., n_windows,
    N_METRICS]``. ``evictions`` may be a count per step (byte mode);
    ``occupancy`` is the per-step cached-object count; ``active=None`` means
    every position is a request; ``hit_bytes``/``miss_bytes`` ``None`` fall
    back to unit sizes. ``fired``/``churn`` are per-chunk (..., n_chunks)
    refresh events (``chunk_len`` required with them)."""
    w = window
    hits_w = bucket_sum(hits, w)
    if active is None:
        req_w = window_sizes(trace_len, w, device=hits_w.device).expand(hits_w.shape)
    else:
        req_w = bucket_sum(active, w)
    miss_w = req_w - hits_w
    fill_w = bucket_sum(fills, w)
    evict_w = bucket_sum(evictions, w)
    offer_w = miss_w if offers is None else bucket_sum(offers, w)
    occ_w = bucket_end(occupancy, w)
    hb_w = hits_w if hit_bytes is None else bucket_sum(hit_bytes, w)
    mb_w = miss_w if miss_bytes is None else bucket_sum(miss_bytes, w)
    refr_w = torch.zeros_like(hits_w)
    churn_w = torch.zeros_like(hits_w)
    if aging is not None:
        refr_w = refr_w + bucket_sum(aging, w)
    if fired is not None:
        if chunk_len is None:
            raise ValueError("chunk_len is required with fired/churn")
        m = chunk_window_matrix(fired.shape[-1], chunk_len, trace_len, w, device=hits_w.device)
        refr_w = _wrap_i32(refr_w + _chunks_to_windows(fired, m, False))
        churn_w = _wrap_i32(churn_w + _chunks_to_windows(churn, m, False))
    return torch.stack(
        [req_w, hits_w, miss_w, fill_w, evict_w, offer_w, occ_w, refr_w, churn_w, hb_w, mb_w], dim=-1
    ).to(torch.int32)


def group_onehot(groups, n_groups: int) -> torch.Tensor:
    """(N,) group ids -> (N, n_groups) int32 one-hot. Ids outside ``[0,
    n_groups)`` give all-zero rows: they vanish from every group."""
    g = torch.as_tensor(groups).to(torch.int32)
    return (g.unsqueeze(-1) == torch.arange(n_groups, dtype=torch.int32, device=g.device)).to(torch.int32)


def _gsum(events, og_t: torch.Tensor, window: int) -> torch.Tensor:
    """Scatter a per-step series (..., T) to groups with the (..., T, G)
    one-hot of each position's group, then window it: (..., n_windows, G)."""
    eg = torch.as_tensor(events).to(torch.int64).unsqueeze(-1) * og_t
    return bucket_sum(eg.transpose(-1, -2), window).transpose(-1, -2)


def _gend(series_g, window: int) -> torch.Tensor:
    """End-of-window snapshot per group: (..., T, G) -> (..., n_windows, G)."""
    return bucket_end(torch.as_tensor(series_g).transpose(-1, -2), window).transpose(-1, -2)


def grouped_series_from_run(
    window: int,
    trace_len: int,
    n_groups: int,
    groups_t,
    *,
    hits,
    fills,
    evictions_g,
    occupancy_g,
    active=None,
    offers=None,
    aging=None,
    fired=None,
    churn_g=None,
    hit_bytes=None,
    miss_bytes=None,
    chunk_len: int | None = None,
) -> torch.Tensor:
    """The group-segmented :func:`series_from_run`: ``[..., n_windows,
    n_groups, N_METRICS]``. ``groups_t`` is the group id of each trace
    position, ``(T,)`` or with the events' leading dims: request metrics
    scatter along it. ``evictions_g`` (..., T, G) carries each step's
    victims per group and ``occupancy_g`` (..., T, G) the per-group cached
    counts. plfua_dyn: ``fired`` (..., n_chunks) goes to the group of the
    request that completed the period, ``churn_g`` (..., n_chunks, G) is the
    per-group hot-mask difference."""
    w, g = window, n_groups
    gt = torch.as_tensor(groups_t).to(torch.int32)
    og_t = group_onehot(gt, g)  # (..., T, G)
    hits_wg = _gsum(hits, og_t, w)
    if active is None:
        ones = torch.ones(gt.shape[-1], dtype=torch.int32, device=gt.device)
        req_wg = _gsum(ones, og_t, w).expand(hits_wg.shape)
    else:
        req_wg = _gsum(active, og_t, w)
    miss_wg = req_wg - hits_wg
    fill_wg = _gsum(fills, og_t, w)
    evict_wg = bucket_sum(torch.as_tensor(evictions_g).transpose(-1, -2), w).transpose(-1, -2)
    offer_wg = miss_wg if offers is None else _gsum(offers, og_t, w)
    occ_wg = _gend(occupancy_g, w)
    hb_wg = hits_wg if hit_bytes is None else _gsum(hit_bytes, og_t, w)
    mb_wg = miss_wg if miss_bytes is None else _gsum(miss_bytes, og_t, w)
    refr_wg = torch.zeros_like(hits_wg)
    churn_wg = torch.zeros_like(hits_wg)
    if aging is not None:
        refr_wg = refr_wg + _gsum(aging, og_t, w)
    if fired is not None:
        if chunk_len is None:
            raise ValueError("chunk_len is required with fired/churn_g")
        n_chunks = fired.shape[-1]
        m = chunk_window_matrix(n_chunks, chunk_len, trace_len, w, device=hits_wg.device)
        pos = torch.clamp((torch.arange(n_chunks, device=gt.device) + 1) * chunk_len - 1, max=trace_len - 1)
        cg = group_onehot(gt[..., pos], g)  # (..., n_chunks, G)
        fired_cg = torch.as_tensor(fired).to(torch.int64).unsqueeze(-1) * cg
        refr_wg = _wrap_i32(refr_wg + _chunks_to_windows(fired_cg, m, True))
        churn_wg = _wrap_i32(churn_wg + _chunks_to_windows(churn_g, m, True))
    return torch.stack(
        [req_wg, hits_wg, miss_wg, fill_wg, evict_wg, offer_wg, occ_wg, refr_wg, churn_wg, hb_wg, mb_wg], dim=-1
    ).to(torch.int32)


def windowed_pressure(window: int, groups_t, evictions_g) -> torch.Tensor:
    """Eviction pressure: (..., T, G) per-step victims per group ->
    (..., n_windows, G), counting only victims whose group differs from the
    requester's at that step (a tenant's objects evicted by other tenants'
    fills). With the same-group victims it sums to the grouped evictions."""
    ev = torch.as_tensor(evictions_g)
    gt = torch.as_tensor(groups_t).to(torch.int32)
    g = ev.shape[-1]
    cross = (gt.unsqueeze(-1) != torch.arange(g, dtype=torch.int32, device=gt.device)).to(torch.int32)
    return bucket_sum((ev * cross).transpose(-1, -2), window).transpose(-1, -2)
