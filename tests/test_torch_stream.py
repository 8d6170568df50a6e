"""The port's streaming fleet engine against the reference package's bounded and streaming engines.

The mirror of tests/test_stream.py. The same host trace and edge assignment
go through ``repro.fleet`` (JAX on the CPU) and, as K chunks of G requests,
through ``repro_torch.fleet.FleetStream`` with ``device="cpu"``. Every output
is an integer or a bool, so the tolerance is exact: the stream's per-chunk hit
series, tier counters, final states, origin misses and stitched telemetry and
pressure series must equal the reference's bounded ``simulate_fleet`` over the
concatenated trace, and each chunk's hits the reference's own
``FleetStream.push``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import fleet as ref_fleet
from repro import telemetry as ref_telemetry
from repro import workloads as ref_workloads
from repro.fleet import stream as ref_stream
from repro_torch import fleet, telemetry
from repro_torch.fleet import stream
from repro_torch.fleet.stream import FleetStream, StreamConfig, stream_fleet
from repro_torch.workloads import device as device_mod

N, G, K = 96, 50, 4
T = G * K
ALL_KINDS = ("lru", "lfu", "wlfu", "plfu", "plfua", "plfua_dyn", "tinylfu", "gdsf", "arc")

_rng = np.random.default_rng(0)
GROUPS = _rng.integers(0, 3, size=N).astype(np.int32)
SIZES = _rng.integers(1, 9, size=N).astype(np.int32)
TEL = (25, 3)


def _topo(mod, kind, **kw):
    return mod.tree(n_objects=N, widths=(3, 1), kinds=kind, capacities=(5, 13), window=48 if kind == "wlfu" else 0,
                    refresh=30 if kind == "plfua_dyn" else 0, **kw)


def _push_all(fs, trace, assignment):
    """Push the trace in K chunks; each chunk's result."""
    outs = []
    for c in range(K):
        sl = slice(c * G, (c + 1) * G)
        outs.append(fs.push(trace[sl], None if assignment is None else assignment[sl]))
    return outs


def _assert_matches(bounded, fs, outs, *, tel=False, ctx=""):
    """The stream equals a bounded reference result on the concatenated trace."""
    st = fs.stats()
    for l in range(len(bounded["hit"])):
        cat = torch.cat([o["hit"][l] for o in outs]).numpy()
        np.testing.assert_array_equal(cat, np.asarray(bounded["hit"][l]), err_msg=f"{ctx}: hit level {l}")
        node = torch.cat([o["node_hit"][l] for o in outs], dim=-1).numpy()
        np.testing.assert_array_equal(node, np.asarray(bounded["node_hit"][l]), err_msg=f"{ctx}: node hit {l}")
        assert set(bounded["tiers"][l]) == set(st.tiers[l]), (ctx, l, sorted(st.tiers[l]))
        for k in bounded["tiers"][l]:
            np.testing.assert_array_equal(np.asarray(bounded["tiers"][l][k]), st.tiers[l][k].numpy(),
                                          err_msg=f"{ctx}: tiers[{l}][{k}]")
        assert set(bounded["states"][l]) == set(fs.states()[l]), (ctx, l)
        for k in bounded["states"][l]:
            want = np.asarray(bounded["states"][l][k])
            got = fs.states()[l][k].numpy()
            assert want.dtype == got.dtype and want.shape == got.shape, (ctx, l, k, want.shape, got.shape)
            np.testing.assert_array_equal(want, got, err_msg=f"{ctx}: states[{l}][{k}]")
    origin = torch.cat([o["origin_miss"] for o in outs]).numpy()
    np.testing.assert_array_equal(origin, np.asarray(bounded["origin_miss"]), err_msg=f"{ctx}: origin misses")
    assert st.requests == T and st.chunks == K
    assert st.origin_misses == int(np.asarray(bounded["origin_miss"]).sum()), ctx
    assert st.hits == T - st.origin_misses
    assert st.total_chr == pytest.approx(st.hits / T)
    if tel:
        for l in range(len(bounded["telemetry"])):
            np.testing.assert_array_equal(np.asarray(bounded["telemetry"][l]), st.telemetry[l].numpy(),
                                          err_msg=f"{ctx}: telemetry level {l}")
        if "telemetry_pressure" not in bounded:
            assert st.telemetry_pressure is None, ctx
            return
        for l in range(len(bounded["telemetry_pressure"])):
            np.testing.assert_array_equal(np.asarray(bounded["telemetry_pressure"][l]),
                                          st.telemetry_pressure[l].numpy(), err_msg=f"{ctx}: pressure level {l}")


def _ref_chunk_hits(ref_topo, trace, assignment, **kw):
    """The reference stream's per-chunk hits, each level."""
    fs = ref_stream.FleetStream(ref_stream.StreamConfig(topo=ref_topo, chunk_len=G, **kw.pop("cfg", {})), **kw)
    hits = []
    for c in range(K):
        sl = slice(c * G, (c + 1) * G)
        out = fs.push(jnp.asarray(trace[sl]), None if assignment is None else jnp.asarray(assignment[sl]))
        hits.append([np.asarray(h) for h in out["hit"]])
    return hits


# ----------------------------------------------------------- config contract
def test_stream_config_validation():
    topo = _topo(fleet, "lru")
    with pytest.raises(ValueError, match="chunk_len"):
        StreamConfig(topo=topo, chunk_len=0)
    sticky = fleet.tree(n_objects=N, widths=(3, 2, 1), kinds="lru", capacities=(5, 9, 13),
                        routers=("hash", "sticky", "tree"))
    with pytest.raises(ValueError, match="position-independent"):
        StreamConfig(topo=sticky, chunk_len=G)
    with pytest.raises(ValueError, match="window"):
        StreamConfig(topo=topo, chunk_len=G, telemetry=telemetry.TelemetrySpec(window=30))
    with pytest.raises(ValueError, match="depth-1"):
        StreamConfig(topo=topo, chunk_len=G, fast=True)
    flat_arc = fleet.tree(n_objects=N, widths=(1,), kinds="arc", capacities=13)
    with pytest.raises(ValueError, match="fast=True supports"):
        StreamConfig(topo=flat_arc, chunk_len=G, fast=True)
    flat = fleet.tree(n_objects=N, widths=(1,), kinds="lru", capacities=13)
    with pytest.raises(ValueError, match="telemetry"):
        StreamConfig(topo=flat, chunk_len=G, fast=True, telemetry=telemetry.TelemetrySpec(window=25))
    dyn = fleet.tree(n_objects=N, widths=(1,), kinds="plfua_dyn", capacities=13, refresh=30)
    with pytest.raises(ValueError, match="refresh"):
        StreamConfig(topo=dyn, chunk_len=G, fast=True)  # 30 % 50 != 0
    flat_bytes = fleet.tree(n_objects=N, widths=(1,), kinds="lru", capacities=13, capacity_bytes=40)
    with pytest.raises(ValueError, match="byte mode"):
        StreamConfig(topo=flat_bytes, chunk_len=G, fast=True)


def test_stream_push_contract():
    topo = _topo(fleet, "lru")
    fs = FleetStream(StreamConfig(topo=topo, chunk_len=G), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        fs.push(torch.zeros((G + 1,), dtype=torch.int32))
    sticky_edge = fleet.tree(n_objects=N, widths=(3, 1), kinds="lru", capacities=(5, 13), router="sticky")
    fs = FleetStream(StreamConfig(topo=sticky_edge, chunk_len=G), device="cpu")
    with pytest.raises(ValueError, match="assignment"):
        fs.push(torch.zeros((G,), dtype=torch.int32))
    tel = StreamConfig(topo=topo, chunk_len=G, telemetry=telemetry.TelemetrySpec(25, 3))
    with pytest.raises(ValueError, match="groups"):
        FleetStream(tel, device="cpu")
    with pytest.raises(ValueError, match="sizes"):
        FleetStream(StreamConfig(topo=topo, chunk_len=G), sizes=np.ones(N - 1, np.int32), device="cpu")


# --------------------------------------------- level-major engine, all kinds
@pytest.mark.parametrize("scenario", ["stationary", "churn"])
@pytest.mark.parametrize("kind", ALL_KINDS)
def test_stream_level_major_bit_identity(kind, scenario):
    """K chunks == one bounded reference simulate_fleet, all 9 kinds, with grouped telemetry and byte
    accounting stitched across chunk seams. G = 50 does not divide plfua_dyn's refresh of 30: the
    stream's gcd sub-chunks must reproduce the bounded global-time refreshes. Each chunk's hits also
    equal the reference stream's push."""
    topo, ref_topo = _topo(fleet, kind), _topo(ref_fleet, kind)
    trace = ref_workloads.make_traces(scenario, N, 1, T, seed=3)[0]
    assignment = topo.assignment(trace)
    bounded = ref_fleet.simulate_fleet(ref_topo, jnp.asarray(trace), jnp.asarray(assignment),
                                       ref_telemetry.TelemetrySpec(*TEL), sizes=SIZES, groups=GROUPS)
    fs = FleetStream(StreamConfig(topo=topo, chunk_len=G, telemetry=telemetry.TelemetrySpec(*TEL)), sizes=SIZES,
                     groups=GROUPS, device="cpu")
    outs = _push_all(fs, trace, assignment)
    _assert_matches(bounded, fs, outs, tel=True, ctx=f"{kind}/{scenario}")
    ref_hits = _ref_chunk_hits(ref_topo, trace, assignment, cfg=dict(telemetry=ref_telemetry.TelemetrySpec(*TEL)),
                               sizes=SIZES, groups=GROUPS)
    for c, (want, out) in enumerate(zip(ref_hits, outs)):
        for l, w in enumerate(want):
            np.testing.assert_array_equal(w, out["hit"][l].numpy(), err_msg=f"chunk {c} level {l}")


def test_stream_group_sum_identity():
    """The stitched grouped series sums over the group axis to the bounded ungrouped series: a
    window spill or a double count at a seam would break it."""
    topo, ref_topo = _topo(fleet, "plfua_dyn"), _topo(ref_fleet, "plfua_dyn")
    trace = ref_workloads.make_traces("churn", N, 1, T, seed=11)[0]
    assignment = topo.assignment(trace)
    plain = ref_fleet.simulate_fleet(ref_topo, jnp.asarray(trace), jnp.asarray(assignment),
                                     ref_telemetry.TelemetrySpec(window=25))
    fs = FleetStream(StreamConfig(topo=topo, chunk_len=G, telemetry=telemetry.TelemetrySpec(*TEL)), groups=GROUPS,
                     device="cpu")
    _push_all(fs, trace, assignment)
    st = fs.stats()
    for l in range(topo.n_levels):
        np.testing.assert_array_equal(st.telemetry[l].numpy().sum(axis=2), np.asarray(plain["telemetry"][l]),
                                      err_msg=f"group-sum != ungrouped series, level {l}")


def test_stream_ungrouped_telemetry_three_levels():
    """Ungrouped telemetry on a three-level plfua_dyn tree with differing refresh periods, at a chunk
    length that divides neither period."""
    kw = dict(n_objects=N, widths=(4, 2, 1), kinds="plfua_dyn", capacities=(4, 9, 23), refresh=(30, 45, 20))
    topo, ref_topo = fleet.tree(**kw), ref_fleet.tree(**kw)
    trace = ref_workloads.make_traces("churn", N, 1, T, seed=2)[0]
    assignment = topo.assignment(trace)
    bounded = ref_fleet.simulate_fleet(ref_topo, jnp.asarray(trace), jnp.asarray(assignment),
                                       ref_telemetry.TelemetrySpec(window=25))
    fs = FleetStream(StreamConfig(topo=topo, chunk_len=G, telemetry=telemetry.TelemetrySpec(window=25)),
                     device="cpu")
    outs = _push_all(fs, trace, assignment)
    _assert_matches(bounded, fs, outs, tel=True, ctx="three levels")


# ------------------------------------------------------------- placed engine
@pytest.mark.parametrize("pl", ["lcd", "prob(0.3)", "admit"])
def test_stream_placed_bit_identity(pl):
    """The stream shares the placed engine's prelude and chunk body: parity covers the placement
    sketches, the host's fire flags at global positions and the scattered telemetry."""
    kw = dict(n_objects=N, widths=(3, 1), kinds=("lru", "plfua_dyn"), capacities=(5, 13), refresh=(0, 30),
              placements=("lce", pl))
    topo, ref_topo = fleet.tree(**kw), ref_fleet.tree(**kw)
    trace = ref_workloads.make_traces("churn", N, 1, T, seed=5)[0]
    assignment = topo.assignment(trace)
    bounded = ref_fleet.simulate_fleet(ref_topo, jnp.asarray(trace), jnp.asarray(assignment),
                                       ref_telemetry.TelemetrySpec(*TEL), sizes=SIZES, groups=GROUPS)
    fs = FleetStream(StreamConfig(topo=topo, chunk_len=G, telemetry=telemetry.TelemetrySpec(*TEL)), sizes=SIZES,
                     groups=GROUPS, device="cpu")
    outs = _push_all(fs, trace, assignment)
    _assert_matches(bounded, fs, outs, tel=True, ctx=f"placed {pl}")
    ref_hits = _ref_chunk_hits(ref_topo, trace, assignment, cfg=dict(telemetry=ref_telemetry.TelemetrySpec(*TEL)),
                               sizes=SIZES, groups=GROUPS)
    for c, (want, out) in enumerate(zip(ref_hits, outs)):
        for l, w in enumerate(want):
            np.testing.assert_array_equal(w, out["hit"][l].numpy(), err_msg=f"chunk {c} level {l}")


def test_stream_placed_without_telemetry():
    """A placed stream of one kind at every level (one step group) and no telemetry."""
    kw = dict(n_objects=N, widths=(4, 2, 1), kinds="plfu", capacities=(4, 9, 23), placements="admit")
    topo, ref_topo = fleet.tree(**kw), ref_fleet.tree(**kw)
    trace = ref_workloads.make_traces("stationary", N, 1, T, seed=6)[0]
    assignment = topo.assignment(trace)
    bounded = ref_fleet.simulate_fleet(ref_topo, jnp.asarray(trace), jnp.asarray(assignment))
    fs = FleetStream(StreamConfig(topo=topo, chunk_len=G), device="cpu")
    outs = _push_all(fs, trace, assignment)
    _assert_matches(bounded, fs, outs, ctx="placed admit plfu")


# --------------------------------------------------------- on-device routing
def test_stream_device_routing_hash():
    """push(assignment=None) routes on the device with the id-pure hash router; the reference's
    bounded run is fed the port's assignment."""
    from repro_torch.cdn import router

    topo, ref_topo = (mod.tree(n_objects=N, widths=(4, 1), kinds="lru", capacities=(5, 13))
                      for mod in (fleet, ref_fleet))
    trace = ref_workloads.make_traces("stationary", N, 1, T, seed=13)[0]
    assignment = router.route_device(torch.as_tensor(trace), 4, "hash", session_len=64).numpy()
    bounded = ref_fleet.simulate_fleet(ref_topo, jnp.asarray(trace), jnp.asarray(assignment))
    fs = FleetStream(StreamConfig(topo=topo, chunk_len=G), device="cpu")
    outs = _push_all(fs, trace, None)
    _assert_matches(bounded, fs, outs, ctx="device-routed")


# ------------------------------------------- double-buffered stream_fleet
def test_stream_fleet_generation():
    """stream_fleet's generate-ahead loop == the port's own bounded run over the concatenation of
    the same generated chunks (the port's device generators are contracts, not the reference's
    bits), and the rollup carries the measured wall clock."""
    n_chunks = 4
    dspec = device_mod.DeviceTraceSpec("stationary", N, n_samples=1, trace_len=G, seed=17)
    topo = fleet.tree(n_objects=N, widths=(1, 1), kinds="lru", capacities=(5, 13))
    st = stream_fleet(StreamConfig(topo=topo, chunk_len=G), dspec, n_chunks, device="cpu")
    full = torch.cat([device_mod.gen_stream_chunk(dspec, 0, c, device="cpu") for c in range(n_chunks)])
    bounded = fleet.simulate_fleet(topo, full, torch.zeros(n_chunks * G, dtype=torch.int32), device="cpu")
    assert st.requests == n_chunks * G and st.chunks == n_chunks
    assert st.origin_misses == int(bounded["origin_miss"].sum())
    for l in range(2):
        for k in bounded["tiers"][l]:
            assert torch.equal(st.tiers[l][k], bounded["tiers"][l][k]), (l, k)
    assert st.elapsed_s is not None and st.elapsed_s > 0
    assert st.req_per_s == pytest.approx(st.requests / st.elapsed_s)
    assert st.j_per_step is not None and st.j_per_step > 0
    with pytest.raises(ValueError, match="trace_len"):
        stream_fleet(StreamConfig(topo=topo, chunk_len=G + 1), dspec, 2, device="cpu")
    with pytest.raises(ValueError, match="n_chunks"):
        stream_fleet(StreamConfig(topo=topo, chunk_len=G), dspec, 0, device="cpu")


def test_stream_carry_stays_in_place():
    """Every push writes the fleet state into the tensors the stream allocated: their data_ptrs stay
    the same across pushes, for the level-major and the placed carry."""
    trace = ref_workloads.make_traces("churn", N, 1, T, seed=4)[0]
    for placements in ("lce", "admit"):
        topo = fleet.tree(n_objects=N, widths=(3, 1), kinds="tinylfu", capacities=(5, 13), placements=placements)
        fs = FleetStream(StreamConfig(topo=topo, chunk_len=G), device="cpu")
        ptrs = lambda: [v.data_ptr() for st in fs.states() for v in st.values()]
        first = ptrs()
        _push_all(fs, trace, topo.assignment(trace))
        assert ptrs() == first, placements


def test_stream_refuses_a_missing_card():
    """Without device="cpu" the stream runs on the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    topo = fleet.tree(n_objects=N, widths=(1,), kinds="lru", capacities=13)
    with pytest.raises(RuntimeError):
        FleetStream(StreamConfig(topo=topo, chunk_len=G))


def test_stream_exports():
    assert fleet.StreamConfig is StreamConfig and fleet.FleetStream is FleetStream
    assert fleet.stream_fleet is stream_fleet and fleet.StreamStats is stream.StreamStats
    assert fleet.FAST_KINDS == ref_stream.FAST_KINDS
