"""Pure-Python two-tier hierarchy: the oracle of :mod:`repro_torch.cdn.hierarchy`.

The port's copy of the reference package's ``cdn/reference.py``: a thin
wrapper over the N-tier fleet oracle (:mod:`repro_torch.fleet.reference`) on
the same depth-2 topology the engine runs (``HierarchySpec.topology()``).
``build_policy`` is re-exported from there.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cdn.hierarchy import HierarchySpec
from repro_torch.core import policies
from repro_torch.fleet.reference import build_policy, simulate_fleet_reference

__all__ = ["build_policy", "simulate_hierarchy_reference", "ReferenceResult"]


@dataclasses.dataclass
class ReferenceResult:
    edge_hit: np.ndarray  # (T,) bool
    parent_hit: np.ndarray  # (T,) bool
    edges: list  # per-edge policy objects (hits/misses/evictions populated)
    parent: policies.CachePolicy

    def in_cache(self, n_objects: int) -> tuple[np.ndarray, np.ndarray]:
        """Final contents: (edge (E, n) bool, parent (n,) bool)."""
        edge = np.array([[p.contains(i) for i in range(n_objects)] for p in self.edges])
        parent = np.array([self.parent.contains(i) for i in range(n_objects)])
        return edge, parent


def simulate_hierarchy_reference(hspec: HierarchySpec, trace: np.ndarray, assignment: np.ndarray) -> ReferenceResult:
    res = simulate_fleet_reference(hspec.topology(), trace, assignment)
    return ReferenceResult(edge_hit=res.level_hit[0], parent_hit=res.level_hit[1], edges=res.levels[0],
                           parent=res.levels[1][0])
