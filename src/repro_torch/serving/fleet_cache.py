"""Multi-node content-cache front for the serving engine.

The port of the reference package's ``serving/fleet_cache.py``.
``FleetContentCache`` routes every lookup onto a cache-tier tree: E edge
:class:`ContentCache` nodes (each with its own policy brain) in front of
shared upper tiers, with the router the fleet engine uses
(:mod:`repro_torch.cdn.router`). Two ways to build one:

  * the two-tier signature (``n_edges, edge_capacity, parent_capacity,
    policy=...``);
  * :meth:`FleetContentCache.from_topology` — any
    :class:`repro_torch.fleet.Topology` (arbitrary depth and fan-in); each
    topology node becomes a ContentCache whose brain
    :func:`repro_torch.fleet.build_policy` makes from the node's PolicySpec.

The lookup/offer surface is a single ``ContentCache``'s, so ``ServeEngine``
takes it as its ``content_cache``:

  * ``lookup`` — route to a node per level (the edge router, then each upper
    level's own router kind or the static parent map), probe the climb for
    the serving tier, then fill on read, gated by placement: each consulted
    tier below the server stores a copy only when its level's placement says
    so (``lce`` / ``lcd`` / ``prob(p)``, the :mod:`repro_torch.fleet.placement`
    semantics the fleet engine runs; ``admit`` defers to the node's own
    policy admission at this layer).
  * ``offer`` — the computed payload goes to the miss-path tiers the
    placement admitted at lookup time (each tier's own policy still decides).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from repro_torch.cdn import router as router_mod
from repro_torch.fleet import placement as placement_mod
from repro_torch.fleet.reference import build_policy
from repro_torch.fleet.topology import ancestry_path
from repro_torch.serving.content_cache import CacheStats, ContentCache

__all__ = ["FleetContentCache"]


class FleetContentCache:
    def __init__(
        self,
        n_edges: int,
        edge_capacity: int,
        parent_capacity: int,
        *,
        policy: str | list[str] = "plfua",
        parent_policy: str | None = None,
        router: str = "hash",
        session_len: int = 64,
        n_objects: int | None = None,
        window: int | None = None,
        size_of: Callable[[Any], int] = lambda p: 1,
        placements: tuple[str, ...] = (),
    ):
        if n_edges < 1:
            raise ValueError(f"n_edges must be >= 1, got {n_edges}")
        edge_policies = [policy] * n_edges if isinstance(policy, str) else list(policy)
        if len(edge_policies) != n_edges:
            raise ValueError("need one policy name per edge")
        kw = dict(n_objects=n_objects, window=window, size_of=size_of)
        self._init_tree(
            levels=[
                [ContentCache(edge_capacity, p, **kw) for p in edge_policies],
                [ContentCache(parent_capacity, parent_policy or edge_policies[0], **kw)],
            ],
            parents=[[0] * n_edges],
            router=router,
            session_len=session_len,
            placements=placements,
        )

    @classmethod
    def from_topology(cls, topo, *, size_of: Callable[[Any], int] = lambda p: 1) -> "FleetContentCache":
        """The serving front on a :class:`repro_torch.fleet.Topology`: one ContentCache per node,
        brains built from each PolicySpec, the tree's per-level routers and placements honoured on
        every lookup's climb."""
        self = cls.__new__(cls)
        self._init_tree(
            levels=[
                [ContentCache(s.capacity, s.kind, size_of=size_of, policy_obj=build_policy(s)) for s in lvl]
                for lvl in topo.levels
            ],
            parents=[list(p) for p in topo.parents],
            router=topo.router,
            session_len=topo.session_len,
            placements=topo.placements,
            routers=topo.routers,
        )
        return self

    def _init_tree(self, levels, parents, router, session_len, placements=(), routers=()):
        if router not in router_mod.ROUTER_MODES:
            raise ValueError(f"unknown router {router!r}; expected one of {router_mod.ROUTER_MODES}")
        n_levels = len(levels)
        self.levels: list[list[ContentCache]] = levels
        self.parents: list[list[int]] = parents
        # miss paths along the static tree: the per-lookup path when no upper level routes by kind
        self._paths = [ancestry_path(parents, e) for e in range(len(levels[0]))]
        self.router = router
        self.session_len = session_len
        self.placements = tuple(placements) or ("lce",) * n_levels
        if len(self.placements) != n_levels:
            raise ValueError("placements must name every level")
        self._parsed = [placement_mod.parse(p) for p in self.placements]
        self.routers = tuple(routers) or (router,) + (router_mod.TREE,) * (n_levels - 1)
        if len(self.routers) != n_levels or self.routers[0] == router_mod.TREE:
            raise ValueError("routers must name every level (edge not 'tree')")
        self._routed = any(r != router_mod.TREE for r in self.routers[1:])
        self._clock = 0  # request counter driving sticky / round-robin routing
        # obj -> (miss path nodes, per-level placement fill flags)
        self._pending: dict[int, tuple[tuple[int, ...], tuple[bool, ...]]] = {}
        self.parent_fills = 0

    # ------------------------------------------------------ two-tier views
    @property
    def edges(self) -> list[ContentCache]:
        return self.levels[0]

    @property
    def parent(self) -> ContentCache:
        """The root node (for depth-2 trees: the one parent)."""
        return self.levels[-1][0]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    # ------------------------------------------------------------- routing
    def _edge_at(self, obj_id: int, t: int) -> int:
        """The edge a request for ``obj_id`` at clock ``t`` routes to (``cdn.router.route`` on the
        request stream)."""
        key = {"hash": obj_id, "sticky": t // self.session_len, "round_robin": t}[self.router]
        if self.router == "round_robin":
            return int(key % len(self.edges))
        return int(router_mod._mix64(np.asarray([key], np.int64))[0] % np.uint64(len(self.edges)))

    def edge_for(self, obj_id: int) -> int:
        """The edge the *next* request for ``obj_id`` routes to (advances the request clock)."""
        t = self._clock
        self._clock += 1
        return self._edge_at(obj_id, t)

    def path_for(self, edge: int) -> tuple[int, ...]:
        """Node index at every level on the *static-tree* miss path of ``edge`` (routed levels
        pick their node per request instead: see ``path_at``)."""
        return self._paths[edge]

    def path_at(self, obj_id: int, t: int) -> tuple[int, ...]:
        """The full miss path of a request at clock ``t``: the parent map for ``"tree"`` levels,
        each routed level's own router otherwise (the fleet engine's ``level_assignments``)."""
        edge = self._edge_at(obj_id, t)
        if not self._routed:
            return self._paths[edge]
        nodes = [edge]
        for l in range(1, self.n_levels):
            mode = self.routers[l]
            if mode == router_mod.TREE:
                nodes.append(self.parents[l - 1][nodes[-1]])
            else:
                nodes.append(router_mod.route_point(mode, obj_id, t, len(self.levels[l]),
                                                    session_len=self.session_len, seed=l))
        return tuple(nodes)

    def _should_fill(self, level: int, serve: int, t: int) -> bool:
        """Placement decision for a consulted tier that missed, given the serving level
        (``n_levels`` = origin): the fleet engine's fill gate. ``admit`` defers to the node's own
        policy admission at this layer."""
        kind, p = self._parsed[level]
        if kind in ("lce", "admit"):
            return True
        if serve == level + 1:
            return True  # the tier directly below the server always fills
        if kind == "lcd":
            return False
        return bool(placement_mod.prob_fill(t, level, p))

    # ------------------------------------------------------- cache surface
    def lookup(self, obj_id: int) -> Any | None:
        t = self._clock
        self._clock += 1
        path = self.path_at(obj_id, t)
        n_levels = self.n_levels
        # probe the climb (no policy requests) for the serving tier, so the placement gate is
        # known before any tier's admission runs
        serve = n_levels  # = origin
        for l, node in enumerate(path):
            if self.levels[l][node].peek(obj_id) is not None:
                serve = l
                break
        consulted = min(serve, n_levels - 1)
        fills = tuple(self._should_fill(l, serve, t) if l < serve else True for l in range(consulted + 1))
        payload = None
        for l in range(consulted + 1):
            p = self.levels[l][path[l]].lookup(obj_id, fill=fills[l])
            if l == serve:
                payload = p
        if payload is not None:
            # fill the placement-admitted tiers below on the way back down (their admission
            # already ran during the gated climb)
            for ll in range(serve):
                if fills[ll]:
                    self.levels[ll][path[ll]].offer(obj_id, payload)
            if serve > 0:
                self.parent_fills += 1
            self._pending.pop(obj_id, None)
            return payload
        self._pending[obj_id] = (path, fills)  # the open miss and its gates
        return None

    def offer(self, obj_id: int, payload: Any) -> bool:
        """Offer a computed payload to the placement-admitted tiers of the object's open miss
        (tracked per object, so interleaved lookups of other objects do not misplace it).
        Returns whether some tier stored it; False without an open miss."""
        rec = self._pending.pop(obj_id, None)
        if rec is None:
            return False
        path, fills = rec
        stored = False
        for l in range(len(path) - 1, -1, -1):  # top-down, as the fill flows
            if fills[l]:
                stored = self.levels[l][path[l]].offer(obj_id, payload) or stored
        return stored

    # ------------------------------------------------------------- metrics
    def _nodes(self) -> list[ContentCache]:
        return [c for lvl in self.levels for c in lvl]

    @property
    def stats(self) -> CacheStats:
        """Fleet-level aggregate. ``hits`` counts requests served from *any* tier, ``misses``
        only requests that reached the origin, so ``stats.chr`` is the fleet CHR; management time
        sums every node."""
        agg = CacheStats()
        for c in self._nodes():
            agg.inserts += c.stats.inserts
            agg.evictions += c.stats.evictions
            agg.mgmt_time_s += c.stats.mgmt_time_s
            agg.bytes_stored += c.stats.bytes_stored
        # every tier's hits served a request (upper-tier lookups happen only on a lower-tier
        # miss; fills use offer, not lookup)
        agg.hits = sum(c.stats.hits for c in self._nodes())
        total = sum(c.stats.hits + c.stats.misses for c in self.levels[0])
        agg.misses = total - agg.hits
        return agg

    def tier_stats(self) -> dict[str, CacheStats]:
        if self.n_levels == 2:  # two-tier naming
            out = {f"edge[{i}]": c.stats for i, c in enumerate(self.edges)}
            out["parent"] = self.parent.stats
            return out
        return {f"L{l}[{i}]": c.stats for l, lvl in enumerate(self.levels) for i, c in enumerate(lvl)}

    @property
    def metadata_entries(self) -> int:
        return sum(c.metadata_entries for c in self._nodes())

    def __len__(self) -> int:
        return sum(len(c) for c in self._nodes())
