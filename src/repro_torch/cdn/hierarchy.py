"""Two-tier cache hierarchy: an edge fleet in front of one shared parent.

The port of the reference package's ``cdn/hierarchy.py``, a thin wrapper over
the fleet: a :class:`HierarchySpec` is exactly a depth-2
:class:`repro_torch.fleet.Topology` (:func:`repro_torch.fleet.topology.
from_hierarchy`), and :func:`simulate_hierarchy` runs it through
:func:`repro_torch.fleet.simulate_fleet`, reshaping the per-level result into
the two-tier ``edge_hit / parent_hit / edge / parent`` dict.

A ``HierarchySpec`` is always all-``lce``: both tiers are offered each fill
and each tier's own policy admission decides what sticks. The other
placements and per-level routers live on the general ``Topology``. Edges may
differ in capacity and hot size but share ``kind``, ``n_objects`` and
``window`` (their states stack).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cdn import router as router_mod
from repro_torch.core.torch_cache import PolicySpec
from repro_torch.fleet import sim as fleet_sim
from repro_torch.fleet import topology as topo_mod

__all__ = [
    "HierarchySpec",
    "two_tier",
    "simulate_hierarchy",
    "simulate_hierarchy_batch",
]


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """E edge nodes (tier 0) in front of one parent (tier 1); frozen and
    hashable. Validated by building its depth-2 Topology."""

    edges: tuple[PolicySpec, ...]
    parent: PolicySpec
    router: str = "hash"
    session_len: int = 64

    def __post_init__(self):
        if not self.edges:
            raise ValueError("need at least one edge node")
        # one source of validation: the Topology's stacked-state, sketch and router rules
        topo_mod.from_hierarchy(self)

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def n_objects(self) -> int:
        return self.edges[0].n_objects

    def topology(self) -> topo_mod.Topology:
        """The equivalent depth-2 fleet Topology."""
        return topo_mod.from_hierarchy(self)

    def assignment(self, trace: np.ndarray, seed: int = 0) -> np.ndarray:
        """Route a (..., T) trace to edges (on the host, shared with the oracle)."""
        return router_mod.route(trace, self.n_edges, self.router, session_len=self.session_len, seed=seed)


def two_tier(
    kind: str,
    n_objects: int,
    *,
    n_edges: int = 4,
    edge_capacity: int,
    parent_capacity: int,
    router: str = "hash",
    session_len: int = 64,
    window: int = 0,
    refresh: int = 0,
    sketch_width: int = 0,
    doorkeeper: int = 0,
    parent_kind: str | None = None,
) -> HierarchySpec:
    """A homogeneous E-edge fleet and one (usually bigger) parent. Options of
    0 take each tier's own capacity-derived convention (``core.sketch``)."""
    parent_kind = parent_kind or kind
    edge = PolicySpec(kind=kind, n_objects=n_objects, capacity=edge_capacity, window=window, refresh=refresh,
                      sketch_width=sketch_width, doorkeeper=doorkeeper if kind == "tinylfu" else 0)
    parent = PolicySpec(kind=parent_kind, n_objects=n_objects, capacity=parent_capacity, window=window,
                        refresh=refresh, sketch_width=sketch_width,
                        doorkeeper=doorkeeper if parent_kind == "tinylfu" else 0)
    return HierarchySpec(edges=(edge,) * n_edges, parent=parent, router=router, session_len=session_len)


def _two_tier_view(out: dict, pick) -> dict:
    """The fleet result as the two-tier dict; ``pick`` takes the parent tier's one node."""
    return {
        "edge_hit": out["hit"][0],
        "parent_hit": out["hit"][1],
        "edge": out["tiers"][0],
        "parent": {k: pick(v) for k, v in out["tiers"][1].items()},
        "edge_states": out["states"][0],
        "parent_state": {k: pick(v) for k, v in out["states"][1].items()},
    }


def simulate_hierarchy(hspec: HierarchySpec, trace, assignment, *, device=None) -> dict:
    """Run one ``(T,)`` trace through the hierarchy on ``device`` (the card
    unless ``"cpu"``). Returns a dict of tensors:

      ``edge_hit``   (T,) bool — hit at the assigned edge
      ``parent_hit`` (T,) bool — edge miss served by the parent
      ``edge``       per-edge counters (requests/hits/admitted_requests/
                     inserts/evictions/count), (E,) int32
      ``parent``     the same counters of the parent, 0-d
      ``edge_states`` / ``parent_state`` — final policy states
    """
    out = fleet_sim.simulate_fleet(hspec.topology(), trace, assignment, device=device)
    return _two_tier_view(out, lambda v: v[0])


def simulate_hierarchy_batch(hspec: HierarchySpec, traces, assignments, *, device=None) -> dict:
    """:func:`simulate_hierarchy` over ``(S, T)`` samples, batched: every output gains a leading
    sample axis."""
    out = fleet_sim.simulate_fleet_batch(hspec.topology(), traces, assignments, device=device)
    return _two_tier_view(out, lambda v: v[:, 0])
