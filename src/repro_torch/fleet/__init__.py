"""Fleet subsystem: declarative N-tier cache topologies, the level-major
engine on the card, a pure-Python reference oracle, and per-tier reports.

    from repro_torch import fleet, workloads
    topo = fleet.tree(n_objects=10_000, widths=(8, 2, 1),
                      kinds=("lru", "plfu", "plfu"),
                      capacities=(60, 240, 960))
    traces = workloads.make_traces("churn", 10_000, n_samples=4,
                                   trace_len=20_000)
    out = fleet.simulate_fleet_batch(topo, traces, topo.assignment(traces))
    print(fleet.fleet_report(topo, out).rows())

``routers=`` picks a router kind per level (sticky edges over hashed
regionals, or the ``"tree"`` parent map). Topologies with a non-lce
placement need the time-major placed engine, which is not ported yet
(ROADMAP.md module 8); nor are the multi-device and streaming engines
(modules 11 and 9).
"""
from repro_torch.fleet import placement
from repro_torch.fleet.reference import FleetReferenceResult, build_policy, simulate_fleet_reference
from repro_torch.fleet.report import (
    TENANT_ROW_FIELDS,
    TIER_ROW_FIELDS,
    FleetReport,
    TierReport,
    fleet_report,
    mgmt_ops,
    placement_ops,
)
from repro_torch.fleet.sim import masked_scan, simulate_fleet, simulate_fleet_batch, tier_counters
from repro_torch.fleet.topology import Topology, level_assignments, tree

__all__ = [
    "Topology",
    "tree",
    "placement",
    "placement_ops",
    "level_assignments",
    "simulate_fleet",
    "simulate_fleet_batch",
    "simulate_fleet_reference",
    "FleetReferenceResult",
    "build_policy",
    "FleetReport",
    "TierReport",
    "TIER_ROW_FIELDS",
    "TENANT_ROW_FIELDS",
    "fleet_report",
    "mgmt_ops",
    "masked_scan",
    "tier_counters",
]
