"""The port's level-major fleet engine against the reference package's and the port's oracle.

The same host trace and edge assignment go through ``repro.fleet`` (JAX on the
CPU), through ``repro_torch.fleet`` with ``device="cpu"`` (the plain PyTorch
step) and through the port's pure-Python oracle. Every output is an integer or
a bool, so the tolerance is exact: each key of the engine's result (hit series,
node hits, counters, final states, origin misses, telemetry and pressure) must
equal the reference's bit for bit, and the oracle's hits, final contents and
per-node hits and evictions must agree with both.
"""
import numpy as np
import pytest
import torch

from repro import fleet as ref_fleet
from repro import telemetry as ref_telemetry
from repro import workloads as ref_workloads
from repro.core.jax_cache import PolicySpec as RefSpec
from repro_torch import fleet, telemetry, workloads
from repro_torch.core.torch_cache import PORTED_KINDS, PolicySpec

N, T = 128, 1_200
SCENARIOS = ("churn", "multi_tenant")


def _topo3(mod, kind, n=N, router="hash", **kw):
    """4 edges -> 2 regionals -> 1 root (tests/test_fleet.py's topology)."""
    return mod.tree(n_objects=n, widths=(4, 2, 1), kinds=kind, capacities=(4, 9, 23),
                    window=48 if kind == "wlfu" else 0, router=router, **kw)


def _assert_same(want, got, path="out"):
    """Every key of a reference result equals the port's, dtype and shape included."""
    if isinstance(want, dict):
        assert set(want) == set(got), (path, sorted(want), sorted(got))
        for k in want:
            _assert_same(want[k], got[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{path}[{i}]")
    else:
        a = np.asarray(want)
        assert isinstance(got, torch.Tensor), path
        b = got.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _assert_oracle(topo, out, trace, assignment, sizes=None):
    """The port's oracle agrees with a single-sample port result."""
    ref = fleet.simulate_fleet_reference(topo, trace, assignment, sizes=sizes)
    contents = ref.in_cache(topo.n_objects)
    for l in range(topo.n_levels):
        np.testing.assert_array_equal(out["hit"][l].numpy(), ref.level_hit[l], err_msg=f"hits, level {l}")
        np.testing.assert_array_equal(out["states"][l]["in_cache"].numpy(), contents[l],
                                      err_msg=f"final contents, level {l}")
        assert out["tiers"][l]["hits"].tolist() == [p.hits for p in ref.levels[l]], f"node hits, level {l}"
        assert out["tiers"][l]["evictions"].tolist() == [p.evictions for p in ref.levels[l]], (
            f"node evictions, level {l}")


def _run_both(ref_topo, topo, trace, assignment, **kw):
    want = ref_fleet.simulate_fleet(ref_topo, trace, assignment, **kw)
    got = fleet.simulate_fleet(topo, trace, assignment, device="cpu", **kw)
    _assert_same(dict(want), got)
    return got


@pytest.mark.parametrize("kind", PORTED_KINDS)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_three_tier_matches_reference_and_oracle(kind, scenario):
    trace = workloads.make_traces(scenario, N, n_samples=1, trace_len=T, seed=29)[0]
    topo = _topo3(fleet, kind)
    assignment = topo.assignment(trace)
    out = _run_both(_topo3(ref_fleet, kind), topo, trace, assignment)
    _assert_oracle(topo, out, trace, assignment)


def test_batch_matches_single():
    topo = _topo3(fleet, "lfu")
    traces = workloads.make_traces("diurnal", N, n_samples=3, trace_len=800, seed=2)
    assignments = topo.assignment(traces)
    batched = fleet.simulate_fleet_batch(topo, traces, assignments, device="cpu")
    for s in range(3):
        single = fleet.simulate_fleet(topo, traces[s], assignments[s], device="cpu")
        _assert_same(_map_numpy(single), {k: _pick(v, s) for k, v in batched.items()})


def _pick(tree, s):
    if isinstance(tree, dict):
        return {k: _pick(v, s) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_pick(v, s) for v in tree)
    return tree[s]


def _map_numpy(tree):
    if isinstance(tree, dict):
        return {k: _map_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_numpy(v) for v in tree)
    return tree.numpy()


def test_batch_matches_reference_batch():
    topo, ref_topo = _topo3(fleet, "plfua_dyn", refresh=150), _topo3(ref_fleet, "plfua_dyn", refresh=150)
    traces = workloads.make_traces("flash_crowd", N, n_samples=2, trace_len=700, seed=4)
    assignments = topo.assignment(traces)
    want = ref_fleet.simulate_fleet_batch(ref_topo, traces, assignments)
    _assert_same(dict(want), fleet.simulate_fleet_batch(topo, traces, assignments, device="cpu"))


def _depth_four(mod, spec):
    mk = lambda kind, cap, **kw: spec(kind=kind, n_objects=N, capacity=cap, **kw)
    return mod.Topology(
        levels=(
            tuple(mk("lru", c) for c in (3, 5, 4, 6, 3, 5)),
            (mk("lfu", 9), mk("lfu", 11)),
            (mk("plfu", 16),),
            (mk("plfua", 24, hot_size=60),),
        ),
        parents=((0, 0, 0, 1, 1, 1), (0, 0), (0,)),
        router="hash",
    )


def test_depth_four_heterogeneous_levels():
    """4 tiers, a different kind a level, per-node capacities, non-uniform fan-in."""
    topo = _depth_four(fleet, PolicySpec)
    trace = workloads.make_traces("flash_crowd", N, 1, T, seed=7)[0]
    assignment = topo.assignment(trace)
    out = _run_both(_depth_four(ref_fleet, RefSpec), topo, trace, assignment)
    _assert_oracle(topo, out, trace, assignment)
    # each level's requests are exactly the stream unserved below it
    served = torch.zeros(T, dtype=torch.bool)
    for l in range(4):
        assert int(out["tiers"][l]["requests"].sum()) == int((~served).sum())
        served |= out["hit"][l]
    assert torch.equal(out["origin_miss"], ~served)


@pytest.mark.parametrize("router", ("sticky", "round_robin"))
def test_edge_routers(router):
    topo = _topo3(fleet, "plfu", router=router)
    trace = workloads.make_traces("stationary", N, 1, T, seed=3)[0]
    assignment = topo.assignment(trace)
    out = _run_both(_topo3(ref_fleet, "plfu", router=router), topo, trace, assignment)
    _assert_oracle(topo, out, trace, assignment)


@pytest.mark.parametrize("kind", ("lru", "tinylfu"))
def test_routed_upper_tier(kind):
    """Sticky edges over hashed regionals: the regionals' assignment comes
    from route_level on the engine's device, the oracle's from numpy."""
    routers = ("sticky", "hash", "tree")
    topo = _topo3(fleet, kind, routers=routers)
    assert topo.has_level_routers
    trace = workloads.make_traces("churn", N, 1, T, seed=19)[0]
    assignment = topo.assignment(trace)
    out = _run_both(_topo3(ref_fleet, kind, routers=routers), topo, trace, assignment)
    _assert_oracle(topo, out, trace, assignment)


SIZES = workloads.object_sizes(N, dist="lognormal", corr=0.5, seed=11, median=64)
BYTE_CAPACITIES = (int(4 * SIZES.mean()), int(9 * SIZES.mean()), int(23 * SIZES.mean()))


@pytest.mark.parametrize("kind", ("gdsf", "plfua_dyn"))
def test_byte_capacities(kind):
    """Byte budgets per level over a lognormal catalogue, a bound of 2
    victims at the regionals: counters gain req/hit bytes and resident bytes."""
    kw = dict(capacity_bytes=BYTE_CAPACITIES, max_victims=(0, 2, 0), refresh=200 if kind == "plfua_dyn" else 0)
    topo = _topo3(fleet, kind, **kw)
    trace = workloads.make_traces("churn", N, 1, T, seed=23)[0]
    assignment = topo.assignment(trace)
    out = _run_both(_topo3(ref_fleet, kind, **kw), topo, trace, assignment, sizes=SIZES)
    assert set(out["tiers"][0]) >= {"req_bytes", "hit_bytes", "bytes"}
    _assert_oracle(topo, out, trace, assignment, sizes=SIZES)
    conserved = out["tiers"][0]["req_bytes"].sum() - sum(out["tiers"][l]["hit_bytes"].sum() for l in range(3))
    assert int(conserved) == int(SIZES[trace[out["origin_miss"].numpy()]].sum())


@pytest.mark.parametrize("kind", ("tinylfu", "plfua_dyn", "arc", "wlfu"))
def test_grouped_telemetry_with_pressure(kind):
    """Per-tenant series and cross-tenant pressure, bit-exact; the series
    summed over the groups equals the ungrouped one, and telemetry leaves the
    primary outputs unchanged."""
    kw = dict(refresh=100) if kind == "plfua_dyn" else {}
    topo, ref_topo = _topo3(fleet, kind, **kw), _topo3(ref_fleet, kind, **kw)
    traces = workloads.make_traces("multi_tenant", N, n_samples=2, trace_len=900, seed=31, n_tenants=4)
    assignments = topo.assignment(traces)
    groups = workloads.tenant_groups(N, 4)
    want = ref_fleet.simulate_fleet_batch(ref_topo, traces, assignments, ref_telemetry.TelemetrySpec(37, 4),
                                          SIZES, groups)
    got = fleet.simulate_fleet_batch(topo, traces, assignments, telemetry.TelemetrySpec(37, 4), SIZES, groups,
                                     device="cpu")
    _assert_same(dict(want), got)
    flat = fleet.simulate_fleet_batch(topo, traces, assignments, telemetry.TelemetrySpec(37), SIZES, device="cpu")
    plain = fleet.simulate_fleet_batch(topo, traces, assignments, sizes=SIZES, device="cpu")
    for l in range(3):
        assert torch.equal(got["telemetry"][l].sum(dim=-2), flat["telemetry"][l])
        assert torch.equal(got["hit"][l], plain["hit"][l])


def test_ungrouped_telemetry_matches_reference():
    topo, ref_topo = _topo3(fleet, "plfua_dyn", refresh=90), _topo3(ref_fleet, "plfua_dyn", refresh=90)
    trace = workloads.make_traces("churn", N, 1, 1_000, seed=37)[0]
    assignment = topo.assignment(trace)
    out = _run_both(ref_topo, topo, trace, assignment, telemetry=telemetry.TelemetrySpec(64))
    assert out["telemetry"][0].shape == (4, 16, telemetry.N_METRICS)


def test_fleet_report_reads_the_port_result():
    """fleet_report over the port's result equals the reference's over its own."""
    topo, ref_topo = _topo3(fleet, "plfua"), _topo3(ref_fleet, "plfua")
    traces = ref_workloads.make_traces("flash_crowd", N, 2, 800, seed=9)
    assignments = topo.assignment(traces)
    spec, ref_spec = telemetry.TelemetrySpec(100, 4), ref_telemetry.TelemetrySpec(100, 4)
    groups = workloads.tenant_groups(N, 4)
    got = fleet.fleet_report(topo, fleet.simulate_fleet_batch(topo, traces, assignments, spec, SIZES, groups,
                                                              device="cpu"), telemetry=spec)
    want = ref_fleet.fleet_report(ref_topo, ref_fleet.simulate_fleet_batch(ref_topo, traces, assignments, ref_spec,
                                                                           SIZES, groups), telemetry=ref_spec)
    assert got.rows() == want.rows()
    assert got.window_rows() == want.window_rows()
    assert got.tenant_rows() == want.tenant_rows()
    assert got.mgmt_energy_j == want.mgmt_energy_j and got.total_chr == want.total_chr
