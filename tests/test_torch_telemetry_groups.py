"""The port's tenant-grouped telemetry against the reference's.

With ``TelemetrySpec(W, n_groups=G)`` and an id -> group catalogue the series
is ``[S, n_windows, G, N_METRICS]``: request metrics in the requester's group,
evictions in each victim's, occupancy and plfua_dyn's hot churn per group.
Held bit for bit to ``jax_cache.simulate_batch`` for all nine kinds on
``multi_tenant`` traces with G in {1, 3}, and for the eight budget-capable
kinds under a byte budget; summing over the group axis gives the ungrouped
series. The builders (``grouped_series_from_run``, ``group_onehot``,
``windowed_pressure``) are held to the reference's numpy on random events,
and the port's CPU entry point to the reference kernel in interpret mode.
Everything compared is an integer: the tolerance is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as ref_telemetry
from repro import workloads as ref_workloads
from repro.core import jax_cache
from repro.kernels.cache_sim import ops as ref_ops
from repro.telemetry import spec as ref_spec
from repro_torch import telemetry as port_telemetry
from repro_torch import workloads
from repro_torch.core import torch_cache
from repro_torch.kernels.cache_sim import ops
from repro_torch.telemetry import spec as port_spec

KINDS = ("lru", "lfu", "plfu", "plfua", "wlfu", "tinylfu", "plfua_dyn", "gdsf", "arc")
BYTE_KINDS = ("lru", "lfu", "plfu", "plfua", "wlfu", "tinylfu", "plfua_dyn", "gdsf")
KIND_KW = {
    "wlfu": dict(window=16),
    "tinylfu": dict(window=50, sketch_width=64),
    "plfua_dyn": dict(refresh=111, sketch_width=64),
}
N, CAP, S, T = 60, 6, 2, 500


def _specs(kind, **kw):
    kw = {**KIND_KW.get(kind, {}), **kw}
    return torch_cache.PolicySpec(kind, N, CAP, **kw), jax_cache.PolicySpec(kind, N, CAP, **kw)


def _assert_equal(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    np.testing.assert_array_equal(port, ref)


def _tenants(n_groups, seed=3, t=T):
    traces = workloads.make_traces("multi_tenant", N, S, t, seed=seed, n_tenants=n_groups)
    return traces, workloads.tenant_groups(N, n_groups)


def _run_both(kind, traces, groups, w, n_groups, sizes=None, **kw):
    port, ref = _specs(kind, **kw)
    hits, state, series = torch_cache.simulate_batch(port, traces, port_telemetry.TelemetrySpec(w, n_groups),
                                                     sizes=sizes, groups=groups, device="cpu")
    ref_hits, ref_series = jax_cache.simulate_batch(
        ref, jnp.asarray(traces), ref_telemetry.TelemetrySpec(w, n_groups),
        None if sizes is None else jnp.asarray(sizes), jnp.asarray(groups))
    _assert_equal(hits, ref_hits)
    _assert_equal(series, ref_series)
    return hits, state, series


@pytest.mark.parametrize("n_groups", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_grouped_series_matches_jax(kind, n_groups):
    """Each kind's grouped series; summed over the groups it is the
    ungrouped series, and the last window's occupancy per group counts the
    final residents of each group."""
    traces, groups = _tenants(n_groups)
    _, state, series = _run_both(kind, traces, groups, 7, n_groups)
    assert series.shape == (S, -(-T // 7), n_groups, port_spec.N_METRICS)
    _, _, flat = torch_cache.simulate_batch(_specs(kind)[0], traces, port_telemetry.TelemetrySpec(7), device="cpu")
    assert torch.equal(series.sum(dim=2, dtype=torch.int32), flat)
    residents = [[int(state["in_cache"][s][torch.as_tensor(groups) == g].sum()) for g in range(n_groups)]
                 for s in range(S)]
    assert series[:, -1, :, port_spec.METRIC_INDEX["occupancy"]].tolist() == residents


@pytest.mark.parametrize("capacity", [0, -3])
@pytest.mark.parametrize("kind,kw", [
    ("arc", {}), ("tinylfu", {}), ("tinylfu", dict(doorkeeper=128)), ("wlfu", {}), ("plfua_dyn", dict(hot_size=7)),
])
def test_grouped_series_at_capacity_at_most_zero_matches_jax(kind, kw, capacity):
    """At capacity <= 0 the first victim is id 0 while it is not cached (an empty cache's
    argmin; arc's empty list names it too): the ungrouped series counts the eviction, a
    group counts only an id that left the cache, so the cache's count trails its residents.
    Both series equal jax_cache's; summed over the groups the evictions fall short of the
    ungrouped ones and the occupancy (residents) is at least the count, every other column
    equal. arc counts its residents, so there a victim that was not cached is no eviction
    in either series, and the sum is the ungrouped series."""
    traces, groups = _tenants(3, seed=13)
    kw = {**KIND_KW.get(kind, {}), **kw}
    port = torch_cache.PolicySpec(kind, N, capacity, **kw)
    ref = jax_cache.PolicySpec(kind, N, capacity, **kw)
    series = {}
    for n_groups in (0, 3):
        hits, _, series[n_groups] = torch_cache.simulate_batch(
            port, traces, port_telemetry.TelemetrySpec(7, n_groups), groups=groups if n_groups else None,
            device="cpu")
        ref_hits, ref_series = jax_cache.simulate_batch(
            ref, jnp.asarray(traces), ref_telemetry.TelemetrySpec(7, n_groups), None,
            jnp.asarray(groups) if n_groups else None)
        _assert_equal(hits, ref_hits)
        _assert_equal(series[n_groups], ref_series)
    summed, flat = series[3].sum(dim=2, dtype=torch.int32), series[0]
    if kind == "arc":
        assert torch.equal(summed, flat)
        return
    evictions, occupancy = port_spec.METRIC_INDEX["evictions"], port_spec.METRIC_INDEX["occupancy"]
    assert bool((summed[..., evictions] <= flat[..., evictions]).all())
    assert int(summed[..., evictions].sum()) < int(flat[..., evictions].sum())
    assert bool((summed[..., occupancy] >= flat[..., occupancy]).all())
    others = [i for i in range(port_spec.N_METRICS) if i not in (evictions, occupancy)]
    assert torch.equal(summed[..., others], flat[..., others])


@pytest.mark.parametrize("kind", BYTE_KINDS)
def test_grouped_byte_mode_matches_jax(kind):
    """Byte mode's victims land in their own groups (several for one insert),
    W = 1 puts every step in its own window, and the group sum holds."""
    traces, groups = _tenants(3, seed=8, t=300)
    sizes = ref_workloads.object_sizes(N, dist="pareto", corr=0.5, seed=11, median=8)
    budget = int(8 * sizes.mean())
    _, _, series = _run_both(kind, traces, groups, 1, 3, sizes=sizes, capacity_bytes=budget)
    _, _, flat = torch_cache.simulate_batch(_specs(kind, capacity_bytes=budget)[0], traces,
                                            port_telemetry.TelemetrySpec(1), sizes=sizes, device="cpu")
    assert torch.equal(series.sum(dim=2, dtype=torch.int32), flat)
    assert int(flat[..., port_spec.METRIC_INDEX["evictions"]].max()) >= 1


def test_plfua_dyn_refresh_goes_to_the_completing_requests_group():
    """A refresh lands in the group of trace position (c+1)*refresh - 1, and
    the churn is split by each changed id's group; the tail never fires."""
    traces, groups = _tenants(3, seed=5, t=600)
    _, _, series = _run_both("plfua_dyn", traces, groups, 600, 3, refresh=97)
    refreshes = series[:, 0, :, port_spec.METRIC_INDEX["refreshes"]]
    for s in range(S):
        want = np.bincount(groups[traces[s, [(c + 1) * 97 - 1 for c in range(6)]]], minlength=3)
        assert refreshes[s].tolist() == want.tolist()
    assert int(series[..., port_spec.METRIC_INDEX["hot_churn"]].sum()) > 0


def test_groups_outside_the_range_vanish_as_in_the_reference():
    """``torch_cache`` follows the reference simulator: an id whose group is
    outside [0, G) counts in no group (the kernel's entry point refuses such
    a row instead)."""
    traces, groups = _tenants(3, seed=2)
    groups = groups.copy()
    groups[::7] = 5
    _run_both("lfu", traces, groups, 9, 3)


@pytest.mark.parametrize("capacity", [0, -3])
def test_arc_evictions_at_capacity_at_most_zero_follow_jax_cache(capacity):
    """The two references disagree on arc at capacity <= 0: the reference kernel's
    ungrouped series counts every demotion or drop of a list's LRU as an eviction, also of
    id 0 named by an empty list while it is not cached; jax_cache counts the residents that
    left (its grouped series and the kernel's agree on that). The port follows jax_cache:
    on the CPU entry point every output but the ungrouped evictions equals the reference
    kernel's, and those fall short of the kernel's by the phantom victims."""
    traces, groups = _tenants(3, seed=13)
    call = dict(kind="arc", n_objects=N, capacity=capacity, telemetry_window=7)
    ref = ref_ops.cache_sim(traces, interpret=True, **call)
    port = ops.cache_sim(traces, device="cpu", **call)
    for a, b in zip(port[:3], ref[:3]):
        _assert_equal(a, b)
    evictions = port_spec.METRIC_INDEX["evictions"]
    others = [i for i in range(port_spec.N_METRICS) if i != evictions]
    ref_series = np.asarray(ref[3])
    _assert_equal(port[3][..., others], ref_series[..., others])
    assert bool((port[3][..., evictions].numpy() <= ref_series[..., evictions]).all())
    assert int(port[3][..., evictions].sum()) < int(ref_series[..., evictions].sum())
    _, js = jax_cache.simulate_batch(jax_cache.PolicySpec("arc", N, capacity), jnp.asarray(traces),
                                     ref_telemetry.TelemetrySpec(7))
    _assert_equal(port[3], js)


# ------------------------------------------------------------------ builders
def test_grouped_builders_match_reference():
    rng = np.random.default_rng(11)
    t, w, g, chunk = 90, 8, 3, 20
    groups_t = rng.integers(0, g, t).astype(np.int32)
    ev = dict(
        hits=rng.random((2, t)) < 0.5,
        fills=rng.random((2, t)) < 0.3,
        evictions_g=rng.integers(0, 2, (2, t, g)).astype(np.int32),
        occupancy_g=rng.integers(0, 9, (2, t, g)).astype(np.int32),
        aging=rng.random((2, t)) < 0.05,
        fired=rng.random((2, 5)) < 0.7,
        churn_g=rng.integers(0, 4, (2, 5, g)).astype(np.int32),
        hit_bytes=rng.integers(0, 2**29, (2, t)).astype(np.int32),
        miss_bytes=rng.integers(0, 2**29, (2, t)).astype(np.int32),
    )
    for extra in ({}, dict(active=rng.random((2, t)) < 0.8, offers=rng.random((2, t)) < 0.4)):
        ref = ref_spec.grouped_series_from_run(w, t, g, groups_t, **ev, **extra, chunk_len=chunk)
        port = port_spec.grouped_series_from_run(
            w, t, g, torch.as_tensor(groups_t), **{k: torch.as_tensor(v) for k, v in {**ev, **extra}.items()},
            chunk_len=chunk)
        _assert_equal(port, ref)
    # per-sample position groups (the port's batched form) give each sample's series
    port = port_spec.grouped_series_from_run(
        w, t, g, torch.as_tensor(np.stack([groups_t, groups_t])), **{k: torch.as_tensor(v) for k, v in ev.items()},
        chunk_len=chunk)
    _assert_equal(port, ref_spec.grouped_series_from_run(w, t, g, groups_t, **ev, chunk_len=chunk))
    _assert_equal(port_spec.windowed_pressure(w, torch.as_tensor(groups_t), torch.as_tensor(ev["evictions_g"])),
                  ref_spec.windowed_pressure(w, groups_t, ev["evictions_g"]))
    ids = np.array([0, 2, 1, 3, -1, 2], np.int32)
    _assert_equal(port_spec.group_onehot(torch.as_tensor(ids), 3), ref_spec.group_onehot(ids, 3))


def test_tenant_groups_match_multi_tenant_blocks():
    """The catalogue and the trace generator split the ids alike: each
    request of tenant block k carries group k."""
    traces = workloads.make_traces("multi_tenant", 103, 2, 400, seed=1, n_tenants=4)
    groups = workloads.tenant_groups(103, 4)
    np.testing.assert_array_equal(groups, ref_workloads.tenant_groups(103, 4))
    assert sorted(set(groups[traces].ravel().tolist())) == [0, 1, 2, 3]
    assert np.all(np.diff(groups) >= 0)


# ---------------------------------------------------------- kernel entry
@pytest.mark.parametrize("kind,kw", [
    ("lru", {}),
    ("tinylfu", dict(window=50, sketch_width=64)),
    ("plfua_dyn", dict(refresh=111, sketch_width=64)),
    ("arc", {}),
    ("gdsf", "budget"),
])
def test_ops_grouped_series_matches_reference_kernel(kind, kw):
    if kw == "budget":
        sizes = ref_workloads.object_sizes(N, dist="lognormal", corr=0.5, seed=11, median=16)
        kw = dict(sizes=sizes, capacity_bytes=int(CAP * sizes.mean()))
    traces, groups = _tenants(3, seed=12, t=300)
    call = dict(kind=kind, n_objects=N, capacity=CAP, telemetry_window=23, n_groups=3, **kw)
    ref = ref_ops.cache_sim(traces, groups=jnp.asarray(groups), interpret=True, **call)
    port = ops.cache_sim(traces, groups=groups, device="cpu", **call)
    assert len(port) == len(ref) == 4
    for a, b in zip(port, ref):
        _assert_equal(a, b)
    flat = ops.cache_sim(traces, device="cpu", **{**call, "n_groups": 0})
    assert torch.equal(port[3].sum(dim=2, dtype=torch.int32), flat[3])
