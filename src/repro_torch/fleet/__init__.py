"""Fleet subsystem: declarative N-tier cache topologies, the level-major and
placed engines on the card, a pure-Python reference oracle, and per-tier
reports.

    from repro_torch import fleet, workloads
    topo = fleet.tree(n_objects=10_000, widths=(8, 2, 1),
                      kinds=("lru", "plfu", "plfu"),
                      capacities=(60, 240, 960))
    traces = workloads.make_traces("churn", 10_000, n_samples=4,
                                   trace_len=20_000)
    out = fleet.simulate_fleet_batch(topo, traces, topo.assignment(traces))
    print(fleet.fleet_report(topo, out).rows())

Cross-tier placement (``placements=`` per level: ``lce`` / ``lcd`` /
``prob(p)`` / ``admit``, see :mod:`repro_torch.fleet.placement`) decides which
tiers store a copy on the fill path; a topology with a non-lce placement runs
the time-major placed engine. ``routers=`` picks a router kind per level
(sticky edges over hashed regionals, or the ``"tree"`` parent map). The
two-tier API in :mod:`repro_torch.cdn` is a wrapper over depth-2 topologies.

:mod:`repro_torch.fleet.stream` runs an unbounded request stream as
fixed-shape chunks (``FleetStream``, ``stream_fleet``), bit for bit the
bounded engines over the concatenated trace, with a compact-lane fast path
for one flat cache. :mod:`repro_torch.fleet.shard` runs the fleet over the
ranks of a ``torch.distributed`` process group, sharded by edges
(``simulate_fleet_sharded``) or by trace samples (``simulate_fleet_device``).
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
from repro_torch.fleet.shard import fleet_mesh, mesh_size, simulate_fleet_device, simulate_fleet_sharded
from repro_torch.fleet.sim import masked_scan, simulate_fleet, simulate_fleet_batch, tier_counters
from repro_torch.fleet.stream import FAST_KINDS, FleetStream, StreamConfig, StreamStats, stream_fleet
from repro_torch.fleet.topology import Topology, from_hierarchy, level_assignments, tree

__all__ = [
    "Topology",
    "tree",
    "from_hierarchy",
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
    "fleet_mesh",
    "mesh_size",
    "simulate_fleet_sharded",
    "simulate_fleet_device",
    "StreamConfig",
    "StreamStats",
    "FleetStream",
    "stream_fleet",
    "FAST_KINDS",
]
