"""The port's serving fleet front, ``FleetContentCache``, against the reference package's.

The mirror of tests/test_serving.py's fleet-cache tests and
tests/test_placement.py's serving constructor test. The same lookup and offer
sequence goes through both packages' ``FleetContentCache`` (the port's policy
copies, router and placement against the reference's): every lookup's payload,
every offer's answer, ``stats``, ``tier_stats()`` (all but the measured
management time), ``metadata_entries``, ``parent_fills`` and every node's
contents must be equal. Behind the engine, the fleet front gives the tokens a
cold engine gives and the reference engine's stats.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import fleet as ref_fleet
from repro.configs import get_config as ref_get_config
from repro.core import zipf
from repro.models import build as ref_build
from repro.serving import FleetContentCache as RefFleetContentCache
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import fleet
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import FleetContentCache, Request, ServeEngine

N_OBJ = 50


def _counts(stats) -> tuple:
    """A CacheStats without its measured management time."""
    d = dataclasses.asdict(stats)
    d.pop("mgmt_time_s")
    return tuple(sorted(d.items()))


def _replay(port, ref, trace):
    """Drive both fronts with the same lookups and offers; every answer equal."""
    for x in trace.tolist():
        got, want = port.lookup(int(x)), ref.lookup(int(x))
        assert got == want, (x, got, want)
        if got is None:
            assert port.offer(int(x), ("payload", int(x))) == ref.offer(int(x), ("payload", int(x)))


def _assert_same_front(port, ref):
    assert _counts(port.stats) == _counts(ref.stats)
    assert port.stats.chr == ref.stats.chr
    tiers, ref_tiers = port.tier_stats(), ref.tier_stats()
    assert list(tiers) == list(ref_tiers)
    assert [_counts(s) for s in tiers.values()] == [_counts(s) for s in ref_tiers.values()]
    assert port.metadata_entries == ref.metadata_entries
    assert (port.parent_fills, len(port), port.n_levels) == (ref.parent_fills, len(ref), ref.n_levels)
    for lvl, ref_lvl in zip(port.levels, ref.levels):
        for node, ref_node in zip(lvl, ref_lvl):
            assert node._payloads == ref_node._payloads


TOPOLOGIES = [
    dict(widths=(4, 2, 1), kinds="plfu", capacities=(6, 12, 24)),
    dict(widths=(4, 2, 1), kinds="lru", capacities=(6, 12, 24), placements="lcd"),
    dict(widths=(4, 2, 1), kinds="lfu", capacities=(6, 12, 24), placements="prob(0.5)"),
    dict(widths=(4, 2, 1), kinds="tinylfu", capacities=(6, 12, 24), placements=("admit", "lcd", "lce")),
    dict(widths=(4, 2, 1), kinds=("lru", "plfua", "arc"), capacities=(6, 12, 24), routers=("sticky", "hash", "tree"),
         session_len=16, placements=("lcd", "prob(0.3)", "lce")),
    dict(widths=(3, 1), kinds="plfua_dyn", capacities=(5, 20), router="round_robin", refresh=100),
    dict(widths=(2, 1), kinds="wlfu", capacities=(8, 32), window=64, placements="lcd"),
    dict(widths=(6, 3, 2, 1), kinds="gdsf", capacities=(4, 8, 12, 30), routers=("hash", "round_robin", "tree", "tree"),
         placements=("prob(0.7)", "lcd", "admit", "lce")),
]


@pytest.mark.parametrize("kw", TOPOLOGIES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_from_topology_matches_reference(kw):
    port = FleetContentCache.from_topology(fleet.tree(n_objects=N_OBJ, **kw))
    ref = RefFleetContentCache.from_topology(ref_fleet.tree(n_objects=N_OBJ, **kw))
    _replay(port, ref, zipf.sample_trace(N_OBJ, 3_000, seed=4))
    _assert_same_front(port, ref)
    assert port.stats.hits + port.stats.misses == 3_000


@pytest.mark.parametrize("kw", [
    dict(policy="plfu", router="hash"),
    dict(policy="lru", router="round_robin", placements=("lcd", "lce")),
    dict(policy=["lru", "lfu", "lru", "lfu"], parent_policy="plfua", router="sticky", session_len=20),
    dict(policy="plfua", placements=("prob(0.4)", "lce"), window=10),
])
def test_two_tier_constructor_matches_reference(kw):
    n_edges = len(kw["policy"]) if isinstance(kw["policy"], list) else 4
    port = FleetContentCache(n_edges, 8, 32, n_objects=N_OBJ, **kw)
    ref = RefFleetContentCache(n_edges, 8, 32, n_objects=N_OBJ, **kw)
    _replay(port, ref, zipf.sample_trace(N_OBJ, 3_000, seed=2))
    _assert_same_front(port, ref)
    assert set(port.tier_stats()) == {f"edge[{i}]" for i in range(n_edges)} | {"parent"}


def test_interleaved_misses_and_routing_helpers_match_reference():
    """Lookups of other objects between a miss and its offer; the routing helpers."""
    topo_kw = dict(n_objects=N_OBJ, widths=(4, 2, 1), kinds="lfu", capacities=(3, 6, 12), placements="lcd",
                   routers=("sticky", "hash", "tree"), session_len=5)
    port = FleetContentCache.from_topology(fleet.tree(**topo_kw))
    ref = RefFleetContentCache.from_topology(ref_fleet.tree(**topo_kw))
    trace = zipf.sample_trace(N_OBJ, 600, seed=6)
    for i in range(0, len(trace) - 2, 3):
        a, b, c = (int(v) for v in trace[i:i + 3])
        for x in (a, b, c):
            assert port.lookup(x) == ref.lookup(x)
        for x in (c, a, b):
            assert port.offer(x, f"p{x}") == ref.offer(x, f"p{x}")
    _assert_same_front(port, ref)
    for obj in range(10):
        assert port.path_at(obj, 123) == ref.path_at(obj, 123)
        assert port.edge_for(obj) == ref.edge_for(obj)
    assert [port.path_for(e) for e in range(4)] == [ref.path_for(e) for e in range(4)]
    assert not port.offer(999, "never looked up")


def test_two_tier_serving_constructor_accepts_placement():
    fc = FleetContentCache(2, 4, 16, policy="lru", placements=("lcd", "lce"))
    assert fc.lookup(5) is None
    assert fc.offer(5, "p5")
    assert fc.levels[1][0].peek(5) == "p5"  # the parent stored it
    assert all(e.peek(5) is None for e in fc.levels[0])  # the edges did not


def test_lcd_fill_on_read():
    """Leave-copy-down: a full miss fills the tier below the origin only; the next request hits
    there and promotes the copy to the edge, where the third finds it."""
    fc = FleetContentCache.from_topology(fleet.tree(n_objects=N_OBJ, widths=(2, 1), kinds="lru", capacities=(8, 32),
                                                    placements="lcd"))
    assert fc.lookup(7) is None and fc.offer(7, "payload-7")
    assert fc.levels[1][0].peek(7) == "payload-7"
    assert all(e.peek(7) is None and not e.policy.contains(7) for e in fc.levels[0])
    assert fc.lookup(7) == "payload-7" and fc.parent_fills == 1
    assert any(e.peek(7) == "payload-7" for e in fc.levels[0])
    assert fc.lookup(7) == "payload-7" and fc.parent_fills == 1
    assert not fc.offer(7, "other")


def test_capacity_and_validation():
    fc = FleetContentCache(2, 4, 8, policy="lru", router="round_robin")
    for x in range(100):
        if fc.lookup(x) is None:
            fc.offer(x, x)
    assert all(len(e) <= 4 for e in fc.edges) and len(fc.parent) <= 8
    with pytest.raises(ValueError, match="n_edges"):
        FleetContentCache(0, 4, 8)
    with pytest.raises(ValueError, match="one policy name per edge"):
        FleetContentCache(2, 4, 8, policy=["lru"])
    with pytest.raises(ValueError, match="unknown router"):
        FleetContentCache(2, 4, 8, router="nope")
    with pytest.raises(ValueError, match="placements must name every level"):
        FleetContentCache(2, 4, 8, placements=("lcd",))


# ------------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engines():
    """The reference's reduced smollm-360m and the port's, with the same weights."""
    ref_model = ref_build(ref_get_config("smollm-360m").reduced())
    params = ref_model.init(jax.random.PRNGKey(0))
    model = params_from_jax(build(get_config("smollm-360m").reduced(), device="cpu"),
                            jax.tree_util.tree_map(np.asarray, params))
    return ref_model, params, model


def _requests(n_objects=20, n_requests=30, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    trace = zipf.sample_trace(n_objects, n_requests, seed=seed)
    prompts = {i: rng.integers(0, 200, size=8).astype(np.int32) for i in range(n_objects)}
    return [cls(obj_id=int(x), tokens=prompts[int(x)], max_new=4) for x in trace]


def test_fleet_cache_in_engine_matches_reference(engines):
    """The fleet front is the engine's content cache: the reference engine's tokens, stats and
    report, and a cold engine's tokens."""
    ref_model, params, model = engines
    kw = dict(n_objects=20, widths=(2, 1), kinds="plfu", capacities=(4, 8), placements="lcd")
    port = ServeEngine(model, cache_len=16, content_cache=FleetContentCache.from_topology(fleet.tree(**kw)))
    ref = RefServeEngine(ref_model, params, cache_len=16,
                         content_cache=RefFleetContentCache.from_topology(ref_fleet.tree(**kw)))
    out = port.run(_requests())
    ref_out = ref.run(_requests(cls=RefRequest))
    cold = ServeEngine(model, cache_len=16).run(_requests())
    assert [dataclasses.astuple(r) for r in out] == [dataclasses.astuple(r) for r in ref_out]
    assert [r.new_tokens for r in out] == [r.new_tokens for r in cold]
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.stats.prefill_tokens_saved > 0
    report, ref_report = port.report(), ref.report()
    assert {k: v for k, v in report.items() if k != "mgmt_time_s"} == {
        k: v for k, v in ref_report.items() if k != "mgmt_time_s"}


def test_fleet_hits_leave_stored_payloads_unchanged(engines):
    """Decode writes in place: a payload the fleet holds (at the parent, then the edge too) stays
    bit for bit what prefill gave, and every hit generates the first serve's tokens."""
    model = engines[2]
    fc = FleetContentCache.from_topology(fleet.tree(n_objects=20, widths=(2, 1), kinds="lru", capacities=(4, 8),
                                                    placements="lcd"))
    eng = ServeEngine(model, cache_len=16, content_cache=fc)
    req = _requests(n_requests=1)[0]
    first = eng.generate(req)
    stored_cache, pos, logits = fc.parent._payloads[req.obj_id]
    snapshot = {k: v.clone() for k, v in stored_cache.items()}, logits.clone()
    second, third = eng.generate(req), eng.generate(req)
    assert second.prefill_skipped and third.prefill_skipped and fc.parent_fills == 1
    assert first.new_tokens == second.new_tokens == third.new_tokens
    for name, tensor in stored_cache.items():
        assert torch.equal(tensor, snapshot[0][name]), name
    assert torch.equal(logits, snapshot[1]) and pos == len(req.tokens)
