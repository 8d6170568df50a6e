"""The port's host copies for the fleet, each pinned to its original on the same inputs.

``repro_torch`` imports nothing of ``repro``, so the fleet's pure-Python and
numpy modules are copies: the topology, placement, the oracle, the report,
the router's numpy paths, and telemetry's latency model, oracle, exporters
and dashboard. Each is held here to the reference package's module on the
same inputs, exactly; then ``route_level``'s torch path to its numpy path,
bit for bit.
"""
import numpy as np
import pytest
import torch

from repro import fleet as ref_fleet
from repro.cdn import router as ref_router
from repro.core import policies as ref_policies
from repro.core.jax_cache import PolicySpec as RefSpec
from repro.fleet import placement as ref_placement
from repro.fleet import reference as ref_reference
from repro.fleet import report as ref_report
from repro.telemetry import dashboard as ref_dashboard
from repro.telemetry import export as ref_export
from repro.telemetry import latency as ref_latency
from repro.telemetry import oracle as ref_oracle
from repro_torch import fleet, workloads
from repro_torch.cdn import router
from repro_torch.core import policies
from repro_torch.core.torch_cache import PORTED_KINDS, PolicySpec
from repro_torch.fleet import placement, reference, report
from repro_torch.telemetry import dashboard, export, latency, oracle

N, T = 96, 700
TOPO_KW = dict(n_objects=N, widths=(4, 2, 1), capacities=(3, 8, 20))
SIZES = workloads.object_sizes(N, dist="pareto", corr=0.5, seed=5, median=64)


def _spec_fields(spec):
    return tuple(getattr(spec, f) for f in ("kind", "n_objects", "capacity", "hot_size", "window", "refresh",
                                            "sketch_width", "doorkeeper", "capacity_bytes", "max_victims"))


def _topo_view(topo):
    return ([[_spec_fields(s) for s in lvl] for lvl in topo.levels], topo.parents, topo.router, topo.session_len,
            topo.names, topo.placements, topo.routers, topo.n_nodes, topo.has_placement, topo.has_level_routers)


def _pair(kind="lru", **kw):
    kw = {**TOPO_KW, "kinds": kind, "window": 40 if kind == "wlfu" else 0, **kw}
    return ref_fleet.tree(**kw), fleet.tree(**kw)


# ------------------------------------------------------------------ topology
@pytest.mark.parametrize("kw", [
    dict(),
    dict(kinds=("lru", "plfu", "tinylfu"), doorkeeper=64, router="sticky", session_len=7),
    dict(placements=("lcd", "prob(0.25)", "admit"), level_names=("a", "b", "c")),
    dict(routers=("round_robin", "hash", "tree"), capacity_bytes=(300, 0, 900), max_victims=(2, 0, 0)),
])
def test_tree_matches_reference(kw):
    want, got = _pair(**kw)
    assert _topo_view(got) == _topo_view(want)
    assert [got.ancestry(e) for e in range(4)] == [want.ancestry(e) for e in range(4)]
    traces = workloads.make_traces("stationary", N, 2, T, seed=1)
    np.testing.assert_array_equal(got.assignment(traces), want.assignment(traces))
    assignment = got.assignment(traces)
    for a, b in zip(ref_fleet.level_assignments(want, traces, assignment),
                    fleet.level_assignments(got, traces, assignment)):
        np.testing.assert_array_equal(a, b)
        assert b.dtype == np.int32
    # the torch path gives the numpy path's assignments
    for a, b in zip(fleet.level_assignments(got, traces, assignment),
                    fleet.level_assignments(got, torch.as_tensor(traces), torch.as_tensor(assignment))):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("build,match", [
    (lambda m, s: m.Topology(levels=((s("lru", N, 4), s("lfu", N, 4)),), parents=()), "share kind"),
    (lambda m, s: m.Topology(levels=((s("lfu", N, 4),), (s("lfu", 2 * N, 8),)), parents=((0,),)), "share n_objects"),
    (lambda m, s: m.Topology(levels=((s("lfu", N, 4),), (s("lfu", N, 8),)), parents=()), "one parents tuple"),
    (lambda m, s: m.Topology(levels=((s("lfu", N, 4),), (s("lfu", N, 8),)), parents=((1,),)), "out of range"),
    (lambda m, s: m.tree(n_objects=N, widths=(2, 1), kinds="lru", capacities=(4, 8), router="nope"), "unknown router"),
    (lambda m, s: m.tree(n_objects=N, widths=(2, 1), kinds="lru", capacities=(4, 8, 16)), "one entry per level"),
    (lambda m, s: m.tree(n_objects=N, widths=(2, 1), kinds="lru", capacities=4, placements="lcx"), "unknown placement"),
    (lambda m, s: m.tree(n_objects=N, widths=(2, 1), kinds="lru", capacities=4, routers=("tree", "hash")), "cannot be"),
])
def test_topology_validation_matches_reference(build, match):
    spec = lambda cls: (lambda kind, n, cap: cls(kind=kind, n_objects=n, capacity=cap))
    with pytest.raises(ValueError, match=match) as want:
        build(ref_fleet, spec(RefSpec))
    with pytest.raises(ValueError, match=match) as got:
        build(fleet, spec(PolicySpec))
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- placement
@pytest.mark.parametrize("text", ["lce", "lcd", "admit", "prob(0)", "prob(0.3)", "prob(1.0)", "prob(1e-3)"])
def test_placement_parse_matches_reference(text):
    assert placement.parse(text) == ref_placement.parse(text)
    assert placement.validate(text) == ref_placement.validate(text)


@pytest.mark.parametrize("text", ["prob(2)", "prob(-1)", "prob(x)", "everywhere", 3])
def test_placement_parse_errors_match_reference(text):
    with pytest.raises(ValueError) as want:
        ref_placement.parse(text)
    with pytest.raises(ValueError) as got:
        placement.parse(text)
    assert str(got.value) == str(want.value)


def test_placement_coin_matches_reference():
    t = np.arange(0, 50_000, 7)
    for level in range(4):
        np.testing.assert_array_equal(placement.fill_hash_u32(t, level), ref_placement.fill_hash_u32(t, level))
        assert placement.fill_hash_u32(123, level) == ref_placement.fill_hash_u32(123, level)
        for p in (0.0, 0.01, 0.5, 0.999, 1.0):
            np.testing.assert_array_equal(placement.prob_fill(t, level, p), ref_placement.prob_fill(t, level, p))
            assert bool(placement.prob_fill(9, level, p)) == bool(ref_placement.prob_fill(9, level, p))
    for cap in (1, 40, 1_000):
        specs = (PolicySpec("lfu", N, cap),)
        assert placement.admit_params(specs) == ref_placement.admit_params((RefSpec("lfu", N, cap),))


# -------------------------------------------------------------------- oracle
def _oracle_view(res, n):
    return [h.tolist() for h in res.level_hit], [c.tolist() for c in res.in_cache(n)], [
        [(p.hits, p.misses, p.evictions) for p in lvl] for lvl in res.levels]


@pytest.mark.parametrize("kind", PORTED_KINDS)
@pytest.mark.parametrize("placements", ["lce", ("lcd", "prob(0.4)", "admit")])
def test_oracle_matches_reference(kind, placements):
    """Every kind through the port's oracle and the reference's, the placed
    topologies included (the oracle runs them; the engine does not yet)."""
    kw = dict(refresh=150) if kind == "plfua_dyn" else {}
    want_topo, topo = _pair(kind, placements=placements, **kw)
    trace = workloads.make_traces("churn", N, 1, T, seed=8)[0]
    assignment = topo.assignment(trace)
    want = ref_fleet.simulate_fleet_reference(want_topo, trace, assignment)
    got = fleet.simulate_fleet_reference(topo, trace, assignment)
    assert _oracle_view(got, N) == _oracle_view(want, N)


@pytest.mark.parametrize("kind", ("lru", "lfu", "gdsf", "plfua"))
def test_oracle_in_byte_mode_matches_reference(kind):
    want_topo, topo = _pair(kind, capacity_bytes=(400, 900, 2_000), placements=("lce", "admit", "lce"))
    trace = workloads.make_traces("stationary", N, 1, T, seed=2)[0]
    assignment = topo.assignment(trace)
    want = ref_fleet.simulate_fleet_reference(want_topo, trace, assignment, sizes=SIZES)
    got = fleet.simulate_fleet_reference(topo, trace, assignment, sizes=SIZES)
    assert _oracle_view(got, N) == _oracle_view(want, N)


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_oracle_helpers_match_reference(kind):
    spec = dict(kind=kind, n_objects=N, capacity=6, window=20 if kind == "wlfu" else 0)
    want, got = ref_reference.build_policy(RefSpec(**spec)), reference.build_policy(PolicySpec(**spec))
    assert type(got).__name__ == type(want).__name__
    trace = workloads.make_traces("stationary", N, 1, 300, seed=4)[0].tolist()
    for x in trace:
        assert got.request(x) == want.request(x)
        assert reference.cache_count(got) == ref_reference.cache_count(want)
        if reference.cache_count(got):  # a victim exists only in a non-empty cache
            assert reference.peek_victim(got) == ref_reference.peek_victim(want)


# -------------------------------------------------------------------- report
def _report_pair(kind, tel=None, sizes=None, groups=None, **kw):
    """fleet_report of the port and of the reference over the same (reference)
    result; the port's reads it as torch tensors."""
    want_topo, topo = _pair(kind, **kw)
    traces = workloads.make_traces("multi_tenant", N, 2, T, seed=6, n_tenants=3)
    assignment = topo.assignment(traces)
    from repro import telemetry as ref_telemetry
    from repro_torch import telemetry

    ref_spec = None if tel is None else ref_telemetry.TelemetrySpec(*tel)
    spec = None if tel is None else telemetry.TelemetrySpec(*tel)
    out = ref_fleet.simulate_fleet_batch(want_topo, traces, assignment, ref_spec, sizes, groups)
    as_torch = _to_torch(dict(out))
    return (ref_fleet.fleet_report(want_topo, out, telemetry=ref_spec),
            fleet.fleet_report(topo, as_torch, telemetry=spec))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    return torch.as_tensor(np.array(tree))


@pytest.mark.parametrize("kind,kw", [
    ("lru", {}), ("tinylfu", dict(doorkeeper=64)), ("plfua_dyn", dict(refresh=100)), ("wlfu", {}),
    ("gdsf", dict(capacity_bytes=(300, 800, 2_000))),
])
def test_fleet_report_matches_reference(kind, kw):
    want, got = _report_pair(kind, sizes=SIZES, **kw)
    assert got.rows() == want.rows()
    assert (got.total_chr, got.byte_chr, got.mgmt_energy_j, got.placement_energy_j, got.origin_egress_gb) == (
        want.total_chr, want.byte_chr, want.mgmt_energy_j, want.placement_energy_j, want.origin_egress_gb)
    want_topo, topo = _pair(kind, **kw)
    for cost_model in ("heap", "scan"):
        want = ref_fleet.fleet_report(want_topo, _dummy_result(), cost_model=cost_model, per_op_s=3e-8)
        got = fleet.fleet_report(topo, _to_torch(_dummy_result()), cost_model=cost_model, per_op_s=3e-8)
        assert got.rows() == want.rows()


def _dummy_result():
    """A counter-only result: every node saw 100 requests, 40 hits, 25 inserts, 10 evictions."""
    c = lambda k, v: np.full((k,), v, np.int32)
    tiers = tuple({"requests": c(k, 100), "hits": c(k, 40), "admitted_requests": c(k, 70), "inserts": c(k, 25),
                   "evictions": c(k, 10), "count": c(k, 15)} for k in (4, 2, 1))
    return {"tiers": tiers}


def test_grouped_report_views_match_reference(tmp_path):
    groups = workloads.tenant_groups(N, 3)
    want, got = _report_pair("plfu", tel=(90, 3), sizes=SIZES, groups=groups)
    assert got.window_rows() == want.window_rows()
    assert got.tenant_rows() == want.tenant_rows()
    model = latency.LatencyModel((500.0, 2_000.0, 9_000.0), 40_000.0)
    ref_model = ref_latency.LatencyModel((500.0, 2_000.0, 9_000.0), 40_000.0)
    assert got.tenant_rows(model) == want.tenant_rows(ref_model)
    # the exporters and the dashboard over these rows
    rows = got.window_rows()
    export.write_jsonl(tmp_path / "a.jsonl", rows)
    ref_export.write_jsonl(tmp_path / "b.jsonl", rows)
    assert (tmp_path / "a.jsonl").read_text() == (tmp_path / "b.jsonl").read_text()
    assert export.read_jsonl(tmp_path / "a.jsonl") == rows
    export.write_csv(tmp_path / "a.csv", got.rows() + rows[:5])
    ref_export.write_csv(tmp_path / "b.csv", got.rows() + rows[:5])
    assert export.read_csv(tmp_path / "a.csv") == ref_export.read_csv(tmp_path / "b.csv")
    html = dashboard.render_dashboard(rows, latency=model, tenant_rows=got.tenant_rows(model))
    assert html == ref_dashboard.render_dashboard(rows, latency=ref_model, tenant_rows=want.tenant_rows(ref_model))
    path = dashboard.write_dashboard(tmp_path / "d.html", rows, latency=model)
    assert open(path).read() == ref_dashboard.render_dashboard(rows, latency=ref_model)


def test_cost_models_match_reference():
    for kind in PORTED_KINDS:
        for dk in ((0, 64) if kind == "tinylfu" else (0,)):
            spec = dict(kind=kind, n_objects=N, capacity=7, window=20 if kind == "wlfu" else 0, doorkeeper=dk)
            for cost in ("heap", "scan"):
                assert report.mgmt_ops(PolicySpec(**spec), 1_000, 600, 50, cost, global_requests=4_000) == (
                    ref_report.mgmt_ops(RefSpec(**spec), 1_000, 600, 50, cost, global_requests=4_000))
    specs = (PolicySpec("lfu", N, 9),)
    for pl in ("lce", "lcd", "prob(0.5)", "admit"):
        assert report.placement_ops(pl, specs, 900, 300, 200) == ref_report.placement_ops(
            pl, (RefSpec("lfu", N, 9),), 900, 300, 200)
    assert report.TIER_ROW_FIELDS == ref_report.TIER_ROW_FIELDS
    assert report.TENANT_ROW_FIELDS == ref_report.TENANT_ROW_FIELDS
    with pytest.raises(ValueError, match="cost_model"):
        report.mgmt_ops(specs[0], 1, 1, 1, "fast")


# -------------------------------------------------------------------- router
@pytest.mark.parametrize("mode", router.ROUTER_MODES)
def test_router_numpy_paths_match_reference(mode):
    trace = workloads.make_traces("stationary", 5_000, 3, 2_000, seed=9)
    for n, seed, session in ((1, 0, 64), (3, 0, 64), (8, 5, 17), (13, 1_000_000, 1)):
        kw = dict(session_len=session, seed=seed)
        np.testing.assert_array_equal(router.route(trace, n, mode, **kw), ref_router.route(trace, n, mode, **kw))
        want = ref_router.route_level(trace, n, mode, **kw)
        np.testing.assert_array_equal(router.route_level(trace, n, mode, **kw), want)
        for t in range(0, 2_000, 97):
            x = int(trace[0, t])
            assert router.route_point(mode, x, t, n, **kw) == ref_router.route_point(mode, x, t, n, **kw)
    assert (router.ROUTER_MODES, router.TREE, router.LEVEL_ROUTER_MODES) == (
        ref_router.ROUTER_MODES, ref_router.TREE, ref_router.LEVEL_ROUTER_MODES)


@pytest.mark.parametrize("mode", router.ROUTER_MODES)
@pytest.mark.parametrize("seed", [0, 1, 3, 4_294, 2**31 - 1])
def test_route_level_torch_is_bit_identical(mode, seed):
    """The torch path (int64 masked to 32 bits) against numpy's uint32, over
    ids spanning the whole int32 range."""
    rng = np.random.default_rng(seed)
    trace = rng.integers(0, 2**31 - 1, size=(2, 3_000), dtype=np.int64).astype(np.int32)
    for n in (1, 2, 7, 64, 1_000):
        want = router.route_level(trace, n, mode, session_len=13, seed=seed)
        got = router.route_level(torch.as_tensor(trace), n, mode, session_len=13, seed=seed)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(router.route_device(torch.as_tensor(trace), n, mode, session_len=13,
                                                          seed=seed).numpy(), want)


@pytest.mark.parametrize("call", [
    lambda m: m.route(np.zeros(4, np.int32), 0), lambda m: m.route(np.zeros(4, np.int32), 2, "nope"),
    lambda m: m.route(np.zeros(4, np.int32), 2, "sticky", session_len=0),
    lambda m: m.route_level(np.zeros(4, np.int32), 0), lambda m: m.route_level(np.zeros(4, np.int32), 2, "x"),
    lambda m: m.route_point("sticky", 1, 2, 3, session_len=0), lambda m: m.route_point("hash", 1, 2, 0),
])
def test_router_errors_match_reference(call):
    with pytest.raises(ValueError) as want:
        call(ref_router)
    with pytest.raises(ValueError) as got:
        call(router)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- telemetry
def test_latency_matches_reference():
    for counts, values, q in (([90, 9, 1], [1000.0, 5000.0, 25000.0], 0.95), ([0, 0], [1.0, 2.0], 0.5),
                              ([1, 9, 1, 4], [9.0, 1.0, 4.0, 2.0], 0.5), ([3], [7.0], 1.0)):
        assert latency.percentile_us(counts, values, q) == ref_latency.percentile_us(counts, values, q)
    for n in (1, 3, 5):
        got, want = latency.LatencyModel.default(n), ref_latency.LatencyModel.default(n)
        assert (got.bucket_us, got.n_levels) == (want.bucket_us, want.n_levels)
        hist = np.arange(n + 1) * 7 + 1
        assert got.percentile(hist, 0.99) == want.percentile(hist, 0.99)
        assert got.mean_us(hist) == want.mean_us(hist)
        lh, origin = np.arange(2 * n).reshape(n, 2), np.array([5, 6])
        np.testing.assert_array_equal(got.histogram(lh, origin), want.histogram(lh, origin))
    for bad in (dict(service_us=(), origin_us=1.0), dict(service_us=(1.0, -2.0), origin_us=5.0)):
        with pytest.raises(ValueError):
            latency.LatencyModel(**bad)


_KNOBS = {"wlfu": {"window": 64}, "tinylfu": {"window": 200, "doorkeeper": 64}, "plfua_dyn": {"refresh": 250}}


@pytest.mark.parametrize("kind", PORTED_KINDS)
@pytest.mark.parametrize("n_groups", [0, 3])
def test_telemetry_oracle_matches_reference(kind, n_groups):
    kw = _KNOBS.get(kind, {})
    sizes = SIZES if kind == "gdsf" else None
    trace = workloads.make_traces("multi_tenant", N, 1, 900, seed=23, n_tenants=3)[0]
    groups = workloads.tenant_groups(N, 3) if n_groups else None
    make = lambda mod: mod.make_policy(kind, 12, n_objects=N, sizes=sizes, **kw)
    want = ref_oracle.windowed_reference(make(ref_policies), trace, 128, groups=groups, n_groups=n_groups)
    got = oracle.windowed_reference(make(policies), trace, 128, groups=groups, n_groups=n_groups)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_series_rows_match_reference():
    rng = np.random.default_rng(3)
    flat = rng.integers(0, 50, size=(2, 3, 5, 11)).astype(np.int32)
    grouped = rng.integers(0, 50, size=(3, 4, 2, 11)).astype(np.int32)
    assert export.series_rows(flat, 10, policy="lru") == ref_export.series_rows(flat, 10, policy="lru")
    assert export.series_rows(grouped, 7, labels=["a", "b", "c"], grouped=True, group_labels=["x", "y"]) == (
        ref_export.series_rows(grouped, 7, labels=["a", "b", "c"], grouped=True, group_labels=["x", "y"]))
    for bad in (dict(series=np.zeros((3, 11)), grouped=True), dict(series=np.zeros((3, 5)))):
        with pytest.raises(ValueError):
            export.series_rows(bad["series"], 10, grouped=bad.get("grouped", False))
    assert dashboard.sparkline([1, 5, 2]) == ref_dashboard.sparkline([1, 5, 2])
    assert dashboard.render_dashboard(export.series_rows(flat, 10)) == ref_dashboard.render_dashboard(
        ref_export.series_rows(flat, 10))
