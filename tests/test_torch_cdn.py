"""The port's two-tier CDN hierarchy against the reference package's and the port's oracle.

The mirror of tests/test_cdn.py. ``repro_torch.cdn`` is a depth-2 wrapper over
the port's fleet; the same host trace and edge assignment go through
``repro.cdn`` (JAX on the CPU), through ``repro_torch.cdn`` with
``device="cpu"`` and through the port's ``simulate_hierarchy_reference``.
Every output is an integer or a bool, so the tolerance is exact; the report's
rows are compared as the reference computes them.
"""
import numpy as np
import pytest
import torch

from repro import cdn as ref_cdn
from repro.core.jax_cache import PolicySpec as RefSpec
from repro_torch import cdn, fleet, workloads
from repro_torch.core.torch_cache import PORTED_KINDS, PolicySpec

from test_torch_fleet import _assert_same

N, E, T = 128, 4, 1_000


def _hspec(mod, kind, router="hash", **kw):
    return mod.two_tier(kind, N, n_edges=E, edge_capacity=7, parent_capacity=24, router=router,
                        window=48 if kind == "wlfu" else 0, **kw)


def _assert_oracle(hspec, out, trace, assignment):
    """The port's oracle agrees with a single-sample port result."""
    ref = cdn.simulate_hierarchy_reference(hspec, trace, assignment)
    np.testing.assert_array_equal(out["edge_hit"].numpy(), ref.edge_hit, err_msg="edge hit sequence")
    np.testing.assert_array_equal(out["parent_hit"].numpy(), ref.parent_hit, err_msg="parent hit sequence")
    e_ref, p_ref = ref.in_cache(hspec.n_objects)
    np.testing.assert_array_equal(out["edge_states"]["in_cache"].numpy(), e_ref)
    np.testing.assert_array_equal(out["parent_state"]["in_cache"].numpy(), p_ref)
    assert out["edge"]["evictions"].tolist() == [p.evictions for p in ref.edges]
    assert int(out["parent"]["evictions"]) == ref.parent.evictions
    assert out["edge"]["hits"].tolist() == [p.hits for p in ref.edges]


def _parity(ref_hspec, hspec, trace):
    assignment = hspec.assignment(trace)
    np.testing.assert_array_equal(assignment, ref_hspec.assignment(trace))
    got = cdn.simulate_hierarchy(hspec, trace, assignment, device="cpu")
    _assert_same(dict(ref_cdn.simulate_hierarchy(ref_hspec, trace, assignment)), got)
    _assert_oracle(hspec, got, trace, assignment)
    return got


@pytest.mark.parametrize("kind", PORTED_KINDS)
@pytest.mark.parametrize("scenario", ("stationary", "churn"))
def test_hierarchy_matches_reference_and_oracle(kind, scenario):
    """4 edges and a parent, every kind: the reference's acceptance matrix."""
    trace = workloads.make_traces(scenario, N, n_samples=1, trace_len=T, seed=13)[0]
    _parity(_hspec(ref_cdn, kind), _hspec(cdn, kind), trace)


@pytest.mark.parametrize("router", cdn.ROUTER_MODES)
def test_hierarchy_matches_reference_any_router(router):
    trace = workloads.make_traces("flash_crowd", N, 1, T, seed=3)[0]
    _parity(_hspec(ref_cdn, "plfu", router), _hspec(cdn, "plfu", router), trace)


def test_heterogeneous_edges_match_reference():
    """Edges with different capacities and plfua hot sizes, one batch of rows."""
    caps = ((4, 10), (7, 20), (11, 0), (6, 16))

    def mk(mod, spec):
        return mod.HierarchySpec(edges=tuple(spec(kind="plfua", n_objects=N, capacity=c, hot_size=h) for c, h in caps),
                                 parent=spec(kind="plfua", n_objects=N, capacity=24), router="round_robin")

    trace = workloads.make_traces("multi_tenant", N, 1, T, seed=5)[0]
    _parity(mk(ref_cdn, RefSpec), mk(cdn, PolicySpec), trace)


def test_two_tier_options_match_reference():
    """tinylfu edges with a doorkeeper over an lfu parent, explicit sketch width."""
    kw = dict(doorkeeper=128, sketch_width=64, parent_kind="lfu")
    hspec, ref_hspec = _hspec(cdn, "tinylfu", **kw), _hspec(ref_cdn, "tinylfu", **kw)
    assert hspec.edges[0].doorkeeper == 128 and hspec.parent.doorkeeper == 0
    trace = workloads.make_traces("churn", N, 1, T, seed=8)[0]
    _parity(ref_hspec, hspec, trace)


def test_batch_matches_single_and_reference():
    hspec, ref_hspec = _hspec(cdn, "lfu"), _hspec(ref_cdn, "lfu")
    traces = workloads.make_traces("churn", N, n_samples=3, trace_len=800, seed=2)
    assignments = hspec.assignment(traces)
    batched = cdn.simulate_hierarchy_batch(hspec, traces, assignments, device="cpu")
    _assert_same(dict(ref_cdn.simulate_hierarchy_batch(ref_hspec, traces, assignments)), batched)
    for s in range(3):
        single = cdn.simulate_hierarchy(hspec, traces[s], assignments[s], device="cpu")
        assert torch.equal(batched["edge_hit"][s], single["edge_hit"])
        assert torch.equal(batched["parent_hit"][s], single["parent_hit"])
        assert torch.equal(batched["parent"]["evictions"][s], single["parent"]["evictions"])


def test_counter_conservation():
    hspec = _hspec(cdn, "plfu")
    trace = workloads.make_traces("stationary", N, 1, T, seed=7)[0]
    out = cdn.simulate_hierarchy(hspec, trace, hspec.assignment(trace), device="cpu")
    assert int(out["edge"]["requests"].sum()) == T  # every request reaches exactly one edge
    edge_hits = int(out["edge"]["hits"].sum())
    assert int(out["parent"]["requests"]) == T - edge_hits
    assert bool((out["edge"]["evictions"] >= 0).all()) and int(out["parent"]["evictions"]) >= 0
    assert bool((out["edge"]["count"] <= 7).all()) and int(out["parent"]["count"]) <= 24


@pytest.mark.parametrize("cost_model", ("heap", "scan"))
def test_report_rollup_matches_reference(cost_model):
    hspec, ref_hspec = _hspec(cdn, "plfua"), _hspec(ref_cdn, "plfua")
    traces = workloads.make_traces("flash_crowd", N, 2, 800, seed=9)
    assignments = hspec.assignment(traces)
    rep = cdn.hierarchy_report(hspec, cdn.simulate_hierarchy_batch(hspec, traces, assignments, device="cpu"),
                               cost_model=cost_model)
    want = ref_cdn.hierarchy_report(ref_hspec, ref_cdn.simulate_hierarchy_batch(ref_hspec, traces, assignments),
                                    cost_model=cost_model)
    assert rep.rows() == want.rows()
    assert (rep.n_requests, rep.origin_requests) == (want.n_requests, want.origin_requests) == (
        2 * 800, rep.n_requests - rep.edge.hits - rep.parent.hits)
    assert (rep.edge_chr, rep.parent_chr, rep.total_chr) == (want.edge_chr, want.parent_chr, want.total_chr)
    assert (rep.mgmt_cpu_s, rep.mgmt_energy_j) == (want.mgmt_cpu_s, want.mgmt_energy_j)
    assert rep.total_chr >= rep.edge_chr and rep.mgmt_energy_j > rep.mgmt_cpu_s > 0
    assert len(rep.rows()) == E + 2  # per edge, the aggregate and the parent


def test_churn_acceptance_property():
    """The reference's cdn sweep property at test scale: on churn, plfua_dyn's total CHR is well above
    plfua's (a static hot set goes stale)."""
    traces = workloads.make_traces("churn", N, 2, 2_000, seed=0)
    chr_of = {}
    for kind in ("plfua", "plfua_dyn"):
        hspec = _hspec(cdn, kind, refresh=200 if kind == "plfua_dyn" else 0)
        out = cdn.simulate_hierarchy_batch(hspec, traces, hspec.assignment(traces), device="cpu")
        chr_of[kind] = cdn.hierarchy_report(hspec, out).total_chr
    assert chr_of["plfua_dyn"] > chr_of["plfua"], chr_of


def test_topology_is_the_depth_two_tree():
    hspec = _hspec(cdn, "arc")
    topo = hspec.topology()
    assert topo == fleet.from_hierarchy(hspec)
    assert topo.names == ("edge", "parent") and topo.parents == ((0,) * E,) and not topo.has_placement
    assert topo == fleet.Topology(levels=(hspec.edges, (hspec.parent,)), parents=((0,) * E,), router="hash",
                                  level_names=("edge", "parent"))


def test_two_tier_validation():
    with pytest.raises(ValueError, match="share kind"):
        cdn.HierarchySpec(edges=(PolicySpec(kind="lru", n_objects=N, capacity=4),
                                 PolicySpec(kind="lfu", n_objects=N, capacity=4)),
                          parent=PolicySpec(kind="lfu", n_objects=N, capacity=8))
    with pytest.raises(ValueError, match="share n_objects"):
        cdn.HierarchySpec(edges=(PolicySpec(kind="lfu", n_objects=N, capacity=4),),
                          parent=PolicySpec(kind="lfu", n_objects=2 * N, capacity=8))
    with pytest.raises(ValueError, match="unknown router"):
        cdn.two_tier("lfu", N, edge_capacity=4, parent_capacity=8, router="nope")
    with pytest.raises(ValueError, match="at least one edge"):
        cdn.HierarchySpec(edges=(), parent=PolicySpec(kind="lfu", n_objects=N, capacity=8))


def test_hierarchy_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hspec = _hspec(cdn, "lru")
    trace = workloads.make_traces("stationary", N, 1, 50, seed=1)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cdn.simulate_hierarchy(hspec, trace, hspec.assignment(trace))
