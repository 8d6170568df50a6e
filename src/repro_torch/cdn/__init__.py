"""CDN front: request routing, the two-tier cache hierarchy (an edge fleet in
front of one parent, a depth-2 fleet topology), its pure-Python oracle and its
per-tier CHR, eviction and management-energy roll-ups.

    from repro_torch import cdn, workloads
    hspec = cdn.two_tier("plfu", n_objects=2000, n_edges=4,
                         edge_capacity=60, parent_capacity=240)
    traces = workloads.make_traces("churn", 2000, n_samples=4, trace_len=20_000)
    out = cdn.simulate_hierarchy_batch(hspec, traces, hspec.assignment(traces))
    print(cdn.hierarchy_report(hspec, out).rows())
"""
from repro_torch.cdn import router
from repro_torch.cdn.hierarchy import HierarchySpec, simulate_hierarchy, simulate_hierarchy_batch, two_tier
from repro_torch.cdn.reference import simulate_hierarchy_reference
from repro_torch.cdn.report import HierarchyReport, TierReport, hierarchy_report, mgmt_ops
from repro_torch.cdn.router import ROUTER_MODES, route

__all__ = [
    "HierarchySpec",
    "two_tier",
    "simulate_hierarchy",
    "simulate_hierarchy_batch",
    "simulate_hierarchy_reference",
    "HierarchyReport",
    "TierReport",
    "hierarchy_report",
    "mgmt_ops",
    "ROUTER_MODES",
    "route",
    "router",
]
