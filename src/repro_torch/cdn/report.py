"""Two-tier roll-ups: CHR, evictions, management cost and energy.

The port's copy of the reference package's ``cdn/report.py``. The cost model
(``mgmt_ops``, ``TierReport``, the heap/scan eviction profiles, ``per_op_s``)
is :mod:`repro_torch.fleet.report`'s, re-exported; this module keeps the
two-tier view: :class:`HierarchyReport` with its ``per_edge`` / ``edge``
(aggregate) / ``parent`` split, from a ``simulate_hierarchy`` result (its
tensors on any device, or numpy arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.cdn.hierarchy import HierarchySpec
from repro_torch.fleet.report import TierReport, _host, aggregate_tiers, mgmt_ops  # noqa: F401  (re-exported)
from repro_torch.fleet.report import tier_report as _tier

__all__ = ["TierReport", "HierarchyReport", "mgmt_ops", "hierarchy_report"]


@dataclasses.dataclass
class HierarchyReport:
    """Fleet-level view of one simulated trace (or the sum over a batch)."""

    per_edge: list[TierReport]
    edge: TierReport  # aggregate over the fleet
    parent: TierReport
    n_requests: int
    origin_requests: int  # missed both tiers -> fetched from origin

    @property
    def edge_chr(self) -> float:
        return self.edge.chr

    @property
    def parent_chr(self) -> float:
        return self.parent.chr

    @property
    def total_chr(self) -> float:
        """Served from *some* cache tier (edge or parent)."""
        if not self.n_requests:
            return 0.0
        return (self.edge.hits + self.parent.hits) / self.n_requests

    @property
    def mgmt_cpu_s(self) -> float:
        return self.edge.mgmt_cpu_s + self.parent.mgmt_cpu_s

    @property
    def mgmt_energy_j(self) -> float:
        return self.edge.mgmt_energy_j + self.parent.mgmt_energy_j

    def rows(self) -> list[dict]:
        return [t.row() for t in (*self.per_edge, self.edge, self.parent)]


def hierarchy_report(hspec: HierarchySpec, result: dict[str, Any], *, cost_model: str = "heap",
                     per_op_s: float = 1e-7) -> HierarchyReport:
    """Roll up one ``simulate_hierarchy`` result on the host, in numpy. A
    batched result (a leading sample axis) is summed over its samples: the
    report covers the whole batch."""
    edge_c = {k: _host(v) for k, v in result["edge"].items()}
    parent_c = {k: int(_host(v).sum()) for k, v in result["parent"].items()}
    # collapse an optional sample axis, keeping the edge axis (always last)
    per_edge_c = {k: v.reshape(-1, v.shape[-1]).sum(0) for k, v in edge_c.items()}
    # total trace steps across the batch: every request hits exactly one edge
    total_steps = float(per_edge_c["requests"].sum())
    per_edge = [
        _tier(f"edge[{i}]", hspec.edges[i], {k: per_edge_c[k][i] for k in per_edge_c}, cost_model, per_op_s,
              global_requests=total_steps)
        for i in range(hspec.n_edges)
    ]
    agg = aggregate_tiers("edge", hspec.edges[0].kind, sum(e.capacity for e in hspec.edges), per_edge)
    parent = _tier("parent", hspec.parent, parent_c, cost_model, per_op_s, global_requests=total_steps)
    return HierarchyReport(per_edge=per_edge, edge=agg, parent=parent, n_requests=agg.requests,
                           origin_requests=agg.requests - agg.hits - parent.hits)
