"""Host-side telemetry oracle: re-bucket the Python reference's outcomes.

The port's copy of the reference package's oracle. Drives a paper-faithful
policy object from :mod:`repro_torch.core.policies`
request by request and derives every windowed metric from observable state
transitions (occupancy delta + eviction counter => fills; ``_seen`` reset =>
tinylfu aging; the global-time timer + hot-mask snapshot => plfua_dyn
refresh/churn). The windowed series of ``torch_cache``, the cache_sim kernel
and the fleet engine must equal this array *exactly*.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import policies
from repro_torch.fleet.reference import cache_count
from repro_torch.telemetry.spec import METRIC_INDEX, N_METRICS, n_windows


def windowed_reference(
    policy: "policies.CachePolicy", trace, window: int, *, groups=None, n_groups: int = 0
) -> np.ndarray:
    """(n_windows, N_METRICS) int32 ground-truth series for a flat cache.

    Flat-cache conventions: every position is a request (``active`` all
    true) and every miss is a fill offer (no placement gate).

    With ``groups``/``n_groups`` the series is group-segmented to
    (n_windows, n_groups, N_METRICS): request-attributed metrics go to the
    requester's group while evictions and occupancy are attributed by cache
    *membership* — victims are observed as ids that left the policy's
    ``contains`` set across the request — and the plfua_dyn hot churn is
    split by the group of each flipped hot id. Summing over groups
    reproduces the ungrouped series exactly.
    """
    if n_groups:
        return _grouped_reference(policy, trace, window, groups, n_groups)
    if groups is not None:
        raise ValueError("groups requires n_groups > 0")
    trace = np.asarray(trace)
    T = int(trace.shape[0])
    nw = n_windows(T, window)
    out = np.zeros((nw, N_METRICS), np.int64)
    is_dyn = isinstance(policy, policies.DynamicPLFUACache)
    is_tiny = isinstance(policy, policies.TinyLFUCache)
    if is_dyn and policy.external_refresh:
        raise ValueError("oracle drives the policy's own global-time timer")
    for i, x in enumerate(trace):
        w = i // window
        pre_count = cache_count(policy)
        pre_ev = policy.evictions
        pre_hot = policy._hot.copy() if is_dyn else None
        hit = policy.request(int(x))
        post_count = cache_count(policy)
        evicted = policy.evictions - pre_ev
        out[w, METRIC_INDEX["requests"]] += 1
        out[w, METRIC_INDEX["hits"]] += int(hit)
        out[w, METRIC_INDEX["misses"]] += int(not hit)
        out[w, METRIC_INDEX["fills"]] += post_count - pre_count + evicted
        out[w, METRIC_INDEX["evictions"]] += evicted
        out[w, METRIC_INDEX["fill_offers"]] += int(not hit)
        out[w, METRIC_INDEX["occupancy"]] = post_count
        sz = policy._size(int(x))
        out[w, METRIC_INDEX["hit_bytes"]] += sz * int(hit)
        out[w, METRIC_INDEX["miss_bytes"]] += sz * int(not hit)
        if is_tiny and policy._seen == 0:
            # the request() increment was reset -> the aging window closed
            out[w, METRIC_INDEX["refreshes"]] += 1
        if is_dyn and (i + 1) % policy.refresh == 0:
            out[w, METRIC_INDEX["refreshes"]] += 1
            out[w, METRIC_INDEX["hot_churn"]] += int((pre_hot != policy._hot).sum())
    return out.astype(np.int32)


def _grouped_reference(
    policy: "policies.CachePolicy", trace, window: int, groups, n_groups: int
) -> np.ndarray:
    """(n_windows, n_groups, N_METRICS) grouped ground truth (see above)."""
    if groups is None:
        raise ValueError("n_groups > 0 requires a groups catalogue")
    groups = np.asarray(groups, np.int64)
    if groups.min(initial=0) < 0 or groups.max(initial=-1) >= n_groups:
        raise ValueError(f"groups must be in [0, {n_groups})")
    trace = np.asarray(trace)
    T = int(trace.shape[0])
    nw = n_windows(T, window)
    out = np.zeros((nw, n_groups, N_METRICS), np.int64)
    is_dyn = isinstance(policy, policies.DynamicPLFUACache)
    is_tiny = isinstance(policy, policies.TinyLFUCache)
    if is_dyn and policy.external_refresh:
        raise ValueError("oracle drives the policy's own global-time timer")
    # membership mirror: victims are the ids that leave it across a request,
    # occupancy is its per-group census (both membership-, not requester-,
    # attributed, as the engines' evict_g / count_g group counts)
    cached = {i for i in range(len(groups)) if policy.contains(i)}
    occ = np.zeros(n_groups, np.int64)
    for i in cached:
        occ[groups[i]] += 1
    for i, x in enumerate(trace):
        x = int(x)
        w = i // window
        g = int(groups[x])
        pre_count = cache_count(policy)
        pre_ev = policy.evictions
        pre_hot = policy._hot.copy() if is_dyn else None
        hit = policy.request(x)
        post_count = cache_count(policy)
        evicted = policy.evictions - pre_ev
        victims = [j for j in cached if not policy.contains(j)]
        for j in victims:
            cached.discard(j)
            occ[groups[j]] -= 1
            out[w, groups[j], METRIC_INDEX["evictions"]] += 1
        if x not in cached and policy.contains(x):
            cached.add(x)
            occ[g] += 1
        assert len(victims) == evicted and len(cached) == post_count
        out[w, g, METRIC_INDEX["requests"]] += 1
        out[w, g, METRIC_INDEX["hits"]] += int(hit)
        out[w, g, METRIC_INDEX["misses"]] += int(not hit)
        out[w, g, METRIC_INDEX["fills"]] += post_count - pre_count + evicted
        out[w, g, METRIC_INDEX["fill_offers"]] += int(not hit)
        out[w, :, METRIC_INDEX["occupancy"]] = occ
        sz = policy._size(x)
        out[w, g, METRIC_INDEX["hit_bytes"]] += sz * int(hit)
        out[w, g, METRIC_INDEX["miss_bytes"]] += sz * int(not hit)
        if is_tiny and policy._seen == 0:
            out[w, g, METRIC_INDEX["refreshes"]] += 1
        if is_dyn and (i + 1) % policy.refresh == 0:
            # the refresh is charged to the request that completed the period
            out[w, g, METRIC_INDEX["refreshes"]] += 1
            churn = np.bincount(
                groups[pre_hot != policy._hot], minlength=n_groups
            )
            out[w, :, METRIC_INDEX["hot_churn"]] += churn
    return out.astype(np.int32)
