"""The port's placed fleet engine on its other paths, against the reference package and the oracle.

The second half of the mirror of tests/test_placement.py (the first is
tests/test_torch_placement.py, whose helpers this file shares): byte-mode
admit, mixed placements over plfua_dyn levels with their refreshes, per-level
and edge routers, ungrouped and grouped telemetry with the cross-tenant
pressure, the partial tail chunk, the admit levels' placement sketches, and
``fleet_report``'s placement rows with the lcd-versus-lce acceptance property.
Every output is an integer or a bool: the tolerance is exact.
"""
import numpy as np
import pytest
import torch

from repro import fleet as ref_fleet
from repro import telemetry as ref_telemetry
from repro.core.jax_cache import PolicySpec as RefSpec
from repro_torch import fleet, telemetry, workloads
from repro_torch.core.torch_cache import PolicySpec
from repro_torch.fleet import placement
from repro_torch.fleet import sim as fleet_sim

from test_torch_fleet import _assert_oracle, _assert_same
from test_torch_placement import N, T, _both, _equal_results, _topo

# -------------------------------------------------------------- byte mode
SIZES = workloads.object_sizes(N, dist="lognormal", corr=0.5, seed=11, median=64)
BYTE_CAPACITIES = (int(4 * SIZES.mean()), int(9 * SIZES.mean()), int(23 * SIZES.mean()))


@pytest.mark.parametrize("kind", ("gdsf", "lru", "plfua_dyn", "tinylfu"))
def test_byte_mode_admit_matches_reference_and_oracle(kind):
    """Byte budgets at every level, the regionals bounded to 2 victims: the admit duel's "full" is
    "does not fit as it is"."""
    kw = dict(capacity_bytes=BYTE_CAPACITIES, max_victims=(0, 2, 0), refresh=120 if kind == "plfua_dyn" else 0)
    trace = workloads.make_traces("churn", N, 1, T, seed=23)[0]
    topo, assignment, got = _both(kind, "admit", trace, sizes=SIZES, **kw)
    _assert_oracle(topo, got, trace, assignment, sizes=SIZES)
    assert set(got["tiers"][0]) >= {"req_bytes", "hit_bytes", "bytes"}
    assert int(sum(t["evictions"].sum() for t in got["tiers"])) > 0


def test_sizes_without_byte_budget_add_byte_counters():
    trace = workloads.make_traces("stationary", N, 1, T, seed=2)[0]
    _, _, got = _both("plfu", ("lcd", "admit", "prob(0.3)"), trace, sizes=SIZES)
    conserved = got["tiers"][0]["req_bytes"].sum() - sum(got["tiers"][l]["hit_bytes"].sum() for l in range(3))
    assert int(conserved) == int(SIZES[trace[got["origin_miss"].numpy()]].sum())


# ------------------------------------------- mixed placements, refreshes
def _mixed(mod, spec):
    mk = lambda cap, refresh: spec(kind="plfua_dyn", n_objects=N, capacity=cap, refresh=refresh, sketch_width=64)
    return mod.Topology(levels=((mk(4, 100),) * 4, (mk(9, 150),) * 2, (mk(23, 100),)),
                        parents=((0, 0, 1, 1), (0, 0)), placements=("lcd", "prob(0.5)", "lce"))


def test_mixed_placements_and_dyn_refresh_match_reference_and_oracle():
    """Per-level placements over plfua_dyn levels of different periods (chunks of their gcd, 50)
    and a partial tail period."""
    trace = workloads.make_traces("churn", N, 1, 1030, seed=9)[0]
    topo = _mixed(fleet, PolicySpec)
    assert fleet_sim._dyn_chunk(topo) == 50
    assignment = topo.assignment(trace)
    _assert_same(dict(ref_fleet.simulate_fleet(_mixed(ref_fleet, RefSpec), trace, assignment)),
                 got := fleet.simulate_fleet(topo, trace, assignment, device="cpu"))
    _assert_oracle(topo, got, trace, assignment)


def test_mixed_kinds_and_placements_with_telemetry():
    """The card phase's mixed tree at test size: lru under lcd, plfua_dyn under admit and
    prob(0.5), periods 60 and 90 (chunks of 30), with the windowed series."""
    kw = dict(kinds=("lru", "plfua_dyn", "plfua_dyn"), refresh=(0, 60, 90))
    trace = workloads.make_traces("churn", N, 1, T, seed=21)[0]
    topo = fleet.tree(n_objects=N, widths=(4, 2, 1), capacities=(4, 9, 23), placements=("lcd", "admit", "prob(0.5)"),
                      **kw)
    ref_topo = ref_fleet.tree(n_objects=N, widths=(4, 2, 1), capacities=(4, 9, 23),
                              placements=("lcd", "admit", "prob(0.5)"), **kw)
    assignment = topo.assignment(trace)
    want = ref_fleet.simulate_fleet(ref_topo, trace, assignment, ref_telemetry.TelemetrySpec(50))
    got = fleet.simulate_fleet(topo, trace, assignment, telemetry.TelemetrySpec(50), device="cpu")
    _assert_same(dict(want), got)
    refreshes = got["telemetry"][1][..., telemetry.METRIC_INDEX["refreshes"]].sum(dim=-1)
    assert refreshes.tolist() == [T // 60] * 2


# ------------------------------------------------------ per-level routing
@pytest.mark.parametrize("pl", ("lcd", "admit"))
def test_per_level_routers_match_reference_and_oracle(pl):
    """Sticky edges over hashed regionals."""
    trace = workloads.make_traces("stationary", N, 1, T, seed=3)[0]
    topo, assignment, got = _both("plfu", pl, trace, routers=("sticky", "hash", "tree"), session_len=32)
    assert topo.has_level_routers
    _assert_oracle(topo, got, trace, assignment)


@pytest.mark.parametrize("router", ("sticky", "round_robin"))
def test_edge_routers(router):
    trace = workloads.make_traces("flash_crowd", N, 1, T, seed=6)[0]
    topo, assignment, got = _both("tinylfu", "prob(0.5)", trace, router=router)
    _assert_oracle(topo, got, trace, assignment)


# -------------------------------------------------------------- telemetry
@pytest.mark.parametrize("kind", ("tinylfu", "plfua_dyn", "arc", "gdsf"))
def test_ungrouped_telemetry_matches_reference(kind):
    """The placed engine's fill offers are the consulted misses whose gate was open."""
    kw = dict(refresh=70) if kind == "plfua_dyn" else {}
    trace = workloads.make_traces("churn", N, 1, T, seed=37)[0]
    _, _, got = _both(kind, ("lcd", "admit", "prob(0.5)"), trace, telemetry_spec=(64,), sizes=SIZES, **kw)
    series = got["telemetry"][0]
    assert series.shape == (4, -(-T // 64), telemetry.N_METRICS)
    idx = telemetry.METRIC_INDEX
    assert bool((series[..., idx["fill_offers"]] <= series[..., idx["misses"]]).all())


@pytest.mark.parametrize("kind", ("tinylfu", "plfua_dyn", "wlfu", "lru"))
def test_grouped_telemetry_with_pressure(kind):
    """Per-tenant series and cross-tenant pressure equal the reference's; summed over the groups
    they equal the ungrouped series, and telemetry leaves the primary outputs unchanged."""
    kw = dict(refresh=90) if kind == "plfua_dyn" else {}
    pls = ("admit", "lcd", "prob(0.5)")
    topo, ref_topo = _topo(fleet, kind, pls, **kw), _topo(ref_fleet, kind, pls, **kw)
    traces = workloads.make_traces("multi_tenant", N, n_samples=2, trace_len=500, seed=31, n_tenants=4)
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
        assert torch.equal(got["tiers"][l]["inserts"], plain["tiers"][l]["inserts"])
    assert sum(int(p.sum()) for p in got["telemetry_pressure"]) > 0


@pytest.mark.parametrize("r", [7, 29])
def test_placed_partial_tail_no_leakage(r):
    """T = 4 G + r with the plfua_dyn period G as the chunk: the last chunk is short and must leak
    into no series, snapshot, refresh or counter; prob(1.0) (placed) equals lce (level-major) bit
    for bit, and both equal the reference."""
    g = 30
    t_n = g * 4 + r
    spec = telemetry.TelemetrySpec(window={7: 127, 29: 149}[r], n_groups=3)
    ref_spec = ref_telemetry.TelemetrySpec(window={7: 127, 29: 149}[r], n_groups=3)
    groups = np.random.default_rng(0).integers(0, 3, size=N).astype(np.int32)

    def mk(mod, pl):
        return mod.tree(n_objects=N, widths=(3, 1), kinds=("lru", "plfua_dyn"), capacities=(5, 13), refresh=(0, g),
                        placements=("lce", pl))

    trace = workloads.make_traces("churn", N, 1, t_n, seed=5)[0]
    assignment = mk(fleet, "lce").assignment(trace)
    a = fleet.simulate_fleet(mk(fleet, "lce"), trace, assignment, spec, groups=groups, device="cpu")
    b = fleet.simulate_fleet(mk(fleet, "prob(1.0)"), trace, assignment, spec, groups=groups, device="cpu")
    _equal_results(a, b, f"tail r={r}")
    for key in ("telemetry", "telemetry_pressure"):
        for l in range(2):
            assert torch.equal(a[key][l], b[key][l]), (key, l)
    want = ref_fleet.simulate_fleet(mk(ref_fleet, "prob(1.0)"), trace, assignment, ref_spec, groups=groups)
    _assert_same(dict(want), b)


def test_placement_states_match_reference():
    """The admit levels' sketches: rows (S, K, DEPTH, width) and seen (S, K), int32, as the
    reference's; an admit level only (here the regionals)."""
    traces = workloads.make_traces("stationary", N, 2, T, seed=8)
    pls = ("lcd", "admit", "lce")
    topo, ref_topo = _topo(fleet, "arc", pls), _topo(ref_fleet, "arc", pls)
    assignments = topo.assignment(traces)
    want = ref_fleet.simulate_fleet_batch(ref_topo, traces, assignments)["placement_states"]
    got = fleet.simulate_fleet_batch(topo, traces, assignments, device="cpu")["placement_states"]
    assert set(got) == set(want) == {1}
    width, window = placement.admit_params(topo.levels[1])
    assert tuple(got[1]["rows"].shape) == (2, 2, 4, width) and got[1]["rows"].dtype == torch.int32
    assert bool((got[1]["seen"] < window).all()) and int(got[1]["rows"].sum()) > 0
    _assert_same(want, got)


# ------------------------------------------------------- report + device
def test_placement_report_rows_and_lcd_energy_win():
    """fleet_report over the placed results equals the reference's; lcd beats lce on management
    energy on stationary with total CHR within 2 points (the acceptance property, at
    tests/test_placement.py's scale)."""
    n = 2_000
    traces = workloads.make_traces("stationary", n, 2, 8_000, seed=0)
    reps = {}
    for pl in ("lce", "lcd"):
        kw = dict(n_objects=n, widths=(8, 2, 1), kinds="plfu", capacities=(60, 240, 480), placements=pl)
        topo, ref_topo = fleet.tree(**kw), ref_fleet.tree(**kw)
        assignments = topo.assignment(traces)
        reps[pl] = fleet.fleet_report(topo, fleet.simulate_fleet_batch(topo, traces, assignments, device="cpu"))
        want = ref_fleet.fleet_report(ref_topo, ref_fleet.simulate_fleet_batch(ref_topo, traces, assignments))
        assert reps[pl].rows() == want.rows()
        p_rows = [r for r in reps[pl].rows() if r["tier"].endswith(":placement")]
        assert [r["policy"] for r in p_rows] == [pl] * 3
    assert reps["lcd"].mgmt_energy_j < reps["lce"].mgmt_energy_j
    assert abs(reps["lcd"].total_chr - reps["lce"].total_chr) <= 0.02


def test_placed_engine_runs_on_the_card_by_default(monkeypatch):
    """No fallback: without a card the default device raises, as resolve_device does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = _topo(fleet, "lru", "lcd")
    trace = workloads.make_traces("stationary", N, 1, 50, seed=1)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.simulate_fleet(topo, trace, topo.assignment(trace))


# ------------------------------------------------- levels stepped together
def test_non_adjacent_levels_of_one_kind_step_as_one_group():
    """plfu edges and a plfu root around lru regionals: the engine steps levels 0 and 2 as one batch
    of rows (their specs step alike), level 1 alone; admit at both plfu levels, whose placement
    sketches differ in width (256 and 4 x 80 counters), lcd between."""
    kw = dict(kinds=("plfu", "lru", "plfu"), placements=("admit", "lcd", "admit"), capacities=(4, 9, 80))
    topo = fleet.tree(n_objects=N, widths=(4, 2, 1), **kw)
    assert [fleet_sim._step_signature(lvl[0]) for lvl in topo.levels].count(
        fleet_sim._step_signature(topo.levels[0][0])) == 2
    trace = workloads.make_traces("churn", N, 1, T, seed=43)[0]
    assignment = topo.assignment(trace)
    want = ref_fleet.simulate_fleet(ref_fleet.tree(n_objects=N, widths=(4, 2, 1), **kw), trace, assignment)
    got = fleet.simulate_fleet(topo, trace, assignment, device="cpu")
    _assert_same(dict(want), got)
    _assert_oracle(topo, got, trace, assignment)
    assert got["placement_states"][0]["rows"].shape[-1] == 256 and got["placement_states"][2]["rows"].shape[-1] == 320


def _depth_four(mod, spec, placements):
    mk = lambda kind, cap, **kw: spec(kind=kind, n_objects=N, capacity=cap, **kw)
    return mod.Topology(
        levels=(tuple(mk("lfu", c) for c in (3, 5, 4, 6, 3, 5)), (mk("lfu", 9), mk("lfu", 11)), (mk("lfu", 16),),
                (mk("plfua", 24, hot_size=60),)),
        parents=((0, 0, 0, 1, 1, 1), (0, 0), (0,)), router="hash", placements=placements)


@pytest.mark.parametrize("placements", [("admit", "admit", "lcd", "prob(0.5)"), ("lcd", "prob(0.3)", "admit", "lce")])
def test_depth_four_with_capacities_per_node(placements):
    """Per-node capacities within a level and across the three lfu levels stepped together, fan-in 3
    and 2, a plfua root."""
    topo = _depth_four(fleet, PolicySpec, placements)
    trace = workloads.make_traces("flash_crowd", N, 1, T, seed=7)[0]
    assignment = topo.assignment(trace)
    got = fleet.simulate_fleet(topo, trace, assignment, device="cpu")
    _assert_same(dict(ref_fleet.simulate_fleet(_depth_four(ref_fleet, RefSpec, placements), trace, assignment)), got)
    _assert_oracle(topo, got, trace, assignment)
