"""The port's time-major placed fleet engine against the reference package's and the port's oracle.

The mirror of tests/test_placement.py. The same host trace and edge
assignment go through ``repro.fleet`` (JAX on the CPU) and through
``repro_torch.fleet`` with ``device="cpu"``; every output is an integer or a
bool, so the tolerance is exact: each key of the result (hit series, node
hits, counters, final states, origin misses, the admit levels' placement
sketches, telemetry and pressure) must equal the reference's in value, dtype
and shape, and the port's pure-Python oracle must agree with both. The
``prob(p)`` coin table on torch must equal the numpy coin bit for bit.
"""
import numpy as np
import pytest
import torch

from repro import fleet as ref_fleet
from repro import telemetry as ref_telemetry
from repro.fleet import placement as ref_placement
from repro_torch import fleet, telemetry, workloads
from repro_torch.core import policies, torch_cache
from repro_torch.core.torch_cache import PORTED_KINDS, PolicySpec
from repro_torch.fleet import placement

from test_torch_fleet import _assert_oracle, _assert_same

N, T = 96, 600
PLACED = ("lcd", "prob(0.5)", "admit")


def _topo(mod, kind, placements, *, caps=(4, 9, 23), widths=(4, 2, 1), n=N, **kw):
    """4 edges -> 2 regionals -> 1 root (tests/test_placement.py's topology)."""
    return mod.tree(n_objects=n, widths=widths, kinds=kind, capacities=caps, window=48 if kind == "wlfu" else 0,
                    placements=placements, **kw)


def _both(kind, placements, trace, *, telemetry_spec=None, sizes=None, groups=None, **kw):
    """The reference's and the port's result on one trace; asserts them equal."""
    topo, ref_topo = _topo(fleet, kind, placements, **kw), _topo(ref_fleet, kind, placements, **kw)
    assignment = topo.assignment(trace)
    ref_tel = None if telemetry_spec is None else ref_telemetry.TelemetrySpec(*telemetry_spec)
    port_tel = None if telemetry_spec is None else telemetry.TelemetrySpec(*telemetry_spec)
    want = ref_fleet.simulate_fleet(ref_topo, trace, assignment, ref_tel, sizes, groups)
    got = fleet.simulate_fleet(topo, trace, assignment, port_tel, sizes, groups, device="cpu")
    _assert_same(dict(want), got)
    return topo, assignment, got


def _equal_results(a: dict, b: dict, ctx: str):
    """Two port results equal in every key."""
    assert set(a) >= {"hit", "tiers", "states", "origin_miss"}, ctx
    for key in ("hit", "node_hit", "origin_miss"):
        for x, y in zip(a[key] if isinstance(a[key], tuple) else (a[key],),
                        b[key] if isinstance(b[key], tuple) else (b[key],)):
            assert torch.equal(x, y), (ctx, key)
    for l in range(len(a["tiers"])):
        for part in ("tiers", "states"):
            assert set(a[part][l]) == set(b[part][l]), (ctx, part, l)
            for k in a[part][l]:
                assert torch.equal(a[part][l][k], b[part][l][k]), (ctx, part, l, k)


# ------------------------------------------------------------- the coin
@pytest.mark.parametrize("n_levels", [1, 2, 3, 4])
def test_coin_table_matches_numpy(n_levels):
    """Up to 2**20 positions and 4 levels: the torch table equals the numpy coin (the port's
    and the reference's), the constant ends stay out of it."""
    t_n = 1 << 20
    pls = ("prob(0.5)", "prob(0.125)", "lcd", "prob(0.9)")[:n_levels]
    table = placement.coin_table(pls, t_n, "cpu")
    t = np.arange(t_n)
    for l, pl in enumerate(pls):
        kind, p = placement.parse(pl)
        want = placement.prob_fill(t, l, p) if kind == "prob" else np.zeros(t_n, bool)
        np.testing.assert_array_equal(table[l].numpy(), want, err_msg=f"level {l}")
        if kind == "prob":
            np.testing.assert_array_equal(want, ref_placement.prob_fill(t, l, p, np))
    hashed = placement.fill_hash_u32(torch.arange(t_n), n_levels - 1)
    assert hashed.dtype == torch.int64 and int(hashed.min()) >= 0 and int(hashed.max()) < 1 << 32
    np.testing.assert_array_equal(hashed.numpy(), placement.fill_hash_u32(t, n_levels - 1).astype(np.int64))


def test_coin_table_keeps_constant_ends_out():
    assert placement.coin_table(("lce", "lcd", "admit"), 64, "cpu") is None
    assert placement.coin_table(("prob(1.0)", "prob(0.0)"), 64, "cpu") is None
    assert placement.coin_table(("prob(1.0)", "prob(0.25)"), 64, "cpu")[0].sum() == 0


# ------------------------------------------------- the engine, kind by kind
@pytest.mark.parametrize("pl", PLACED)
@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_placed_engine_matches_reference_and_oracle(kind, pl):
    trace = workloads.make_traces("churn", N, 1, T, seed=17)[0]
    topo, assignment, got = _both(kind, pl, trace)
    _assert_oracle(topo, got, trace, assignment)
    # the admit levels carry their placement sketch, the others none
    assert set(got["placement_states"]) == ({0, 1, 2} if pl == "admit" else set())


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_prob_one_is_lce_bitwise(kind):
    """prob(1.0) runs the placed engine, lce the level-major one: the same result, bit for bit
    (the cross-check between the two engines)."""
    trace = workloads.make_traces("flash_crowd", N, 1, T, seed=11)[0]
    t_lce, t_p1 = _topo(fleet, kind, ()), _topo(fleet, kind, "prob(1.0)")
    assert not t_lce.has_placement and t_p1.has_placement
    assignment = t_lce.assignment(trace)
    _equal_results(fleet.simulate_fleet(t_lce, trace, assignment, device="cpu"),
                   fleet.simulate_fleet(t_p1, trace, assignment, device="cpu"), f"{kind}: prob(1.0) vs lce")


@pytest.mark.parametrize("kind", PORTED_KINDS)
def test_prob_zero_is_lcd_bitwise(kind):
    trace = workloads.make_traces("churn", N, 1, T, seed=13)[0]
    t_lcd, t_p0 = _topo(fleet, kind, "lcd"), _topo(fleet, kind, "prob(0.0)")
    assignment = t_lcd.assignment(trace)
    _equal_results(fleet.simulate_fleet(t_lcd, trace, assignment, device="cpu"),
                   fleet.simulate_fleet(t_p0, trace, assignment, device="cpu"), f"{kind}: prob(0.0) vs lcd")


def test_batch_matches_reference_batch_and_single():
    topo, ref_topo = _topo(fleet, "plfu", "admit"), _topo(ref_fleet, "plfu", "admit")
    traces = workloads.make_traces("diurnal", N, n_samples=3, trace_len=500, seed=2)
    assignments = topo.assignment(traces)
    batched = fleet.simulate_fleet_batch(topo, traces, assignments, device="cpu")
    _assert_same(dict(ref_fleet.simulate_fleet_batch(ref_topo, traces, assignments)), batched)
    for s in range(3):
        single = fleet.simulate_fleet(topo, traces[s], assignments[s], device="cpu")
        assert torch.equal(single["placement_states"][1]["rows"], batched["placement_states"][1]["rows"][s])
        for l in range(3):
            assert torch.equal(single["hit"][l], batched["hit"][l][s])


# ------------------------------------------------------------- invariants
@pytest.mark.parametrize("pl", ("lce",) + PLACED)
@pytest.mark.parametrize("scenario", ("stationary", "churn"))
def test_served_mask_partitions_requests(pl, scenario):
    """Each request is served at one level or the origin; each tier's requests are the stream
    unserved below and routed to it; inserts - evictions = occupancy, whatever the placement."""
    topo = _topo(fleet, "lfu", pl)
    trace = workloads.make_traces(scenario, N, 1, T, seed=41)[0]
    out = fleet.simulate_fleet(topo, trace, topo.assignment(trace), device="cpu")
    served = torch.zeros(T, dtype=torch.bool)
    for l in range(topo.n_levels):
        hit = out["hit"][l]
        assert not bool((served & hit).any()), "served twice"
        c = out["tiers"][l]
        assert int(c["requests"].sum()) == int((~served).sum())
        assert int(c["hits"].sum()) == int(hit.sum())
        assert torch.equal(c["inserts"] - c["evictions"], c["count"])
        assert bool((c["evictions"] >= 0).all())
        served |= hit
    assert torch.equal(out["origin_miss"], ~served)


@pytest.mark.parametrize("kind", ("lru", "plfu", "tinylfu", "arc"))
def test_lcd_occupancy_subset_of_lce(kind):
    """With no eviction pressure every object lcd stores, lce stores too."""
    trace = workloads.make_traces("flash_crowd", N, 1, T, seed=3)[0]
    t_lce, t_lcd = (_topo(fleet, kind, pl, caps=(N, N, N)) for pl in ((), "lcd"))
    assignment = t_lce.assignment(trace)
    a = fleet.simulate_fleet(t_lce, trace, assignment, device="cpu")
    b = fleet.simulate_fleet(t_lcd, trace, assignment, device="cpu")
    for l in range(3):
        assert not bool((b["states"][l]["in_cache"] & ~a["states"][l]["in_cache"]).any()), l


def test_admit_placement_filters_one_hit_wonders():
    """A one-hit-wonder stream: the admit gate keeps tail objects out of a full edge (fewer fills
    than lce) at no meaningful CHR cost, as in the reference."""
    rng = np.random.default_rng(0)
    head = rng.integers(0, 8, size=T)
    tail = np.arange(T) % (N - 8) + 8
    mix = np.where(rng.random(T) < 0.5, head, tail).astype(np.int32)
    topo, assignment, out_admit = _both("lru", "admit", mix, caps=(6, 12, 24))
    out_lce = fleet.simulate_fleet(_topo(fleet, "lru", (), caps=(6, 12, 24)), mix, assignment, device="cpu")
    assert int(out_admit["tiers"][0]["inserts"].sum()) < int(out_lce["tiers"][0]["inserts"].sum())
    assert int(out_admit["hit"][0].sum()) >= int(out_lce["hit"][0].sum()) - 0.02 * T


# --------------------------------------------------------- the gated miss
def test_lfu_parks_frequency_on_gated_miss():
    """In-memory lfu keeps a gated miss's count (the parked-frequency convention): the port's
    policy and its torch step make the reference's decisions on the same gated sequence."""
    seq = [(1, True), (1, True), (2, True), (7, False), (7, False), (7, False), (7, False), (7, True), (3, True)]
    pol = policies.LFUCache(2)
    for x, f in seq:
        pol.request(x, fill=f)
    assert pol.contains(7) and pol.contains(3) and not pol.contains(1) and not pol.contains(2)
    spec = PolicySpec(kind="lfu", n_objects=8, capacity=2)
    state = torch_cache.init_state(spec, n_samples=1, device="cpu")
    for x, f in seq:
        torch_cache.step(spec, state, torch.tensor([x]), fill=torch.tensor([f]))
    np.testing.assert_array_equal(state["in_cache"][0].numpy(), [pol.contains(i) for i in range(8)])
    assert int(state["freq"][0, 7]) == 5  # 4 parked + the filled miss

    # in the fleet: an lcd edge parks the counts of the misses it may not fill
    trace = workloads.make_traces("stationary", N, 1, T, seed=5)[0]
    topo, _, out = _both("lfu", "lcd", trace)
    parked = out["states"][0]["freq"] * ~out["states"][0]["in_cache"]
    assert int(parked.sum()) > 0
