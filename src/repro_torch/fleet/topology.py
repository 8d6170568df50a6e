"""Declarative N-tier cache-fleet topologies.

The port's copy of the reference package's topology module. A
:class:`Topology` is a tree of cache tiers described level by level:
``levels[0]`` is the edge fleet (the tier the router assigns requests to),
``levels[-1]`` is the root tier, and ``parents[l][i]`` names the node at
level ``l+1`` that absorbs the miss stream of node ``i`` at level ``l`` —
arbitrary depth, arbitrary fan-in. The spec is frozen and hashable.

Within one level every node shares ``kind`` / ``n_objects`` / ``window`` (a
level's nodes step as one batch of state rows), but nodes may differ in
``capacity`` / ``capacity_bytes``, and different levels are fully independent
(e.g. LRU edges over PLFU regionals over a TinyLFU root). :func:`tree` builds
symmetric N-tier topologies in one call, :func:`from_hierarchy` the depth-2
topology of a :class:`repro_torch.cdn.HierarchySpec`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import torch

from repro_torch.core import torch_cache
from repro_torch.core.torch_cache import PolicySpec
from repro_torch.fleet import placement as placement_mod

__all__ = [
    "Topology",
    "ancestry_path",
    "from_hierarchy",
    "level_assignments",
    "tree",
]


def ancestry_path(parents, edge: int) -> tuple[int, ...]:
    """Node index at every level on the miss path of ``edge``, given one
    parent map per non-root level (shared by Topology and the serving
    front's FleetContentCache routing)."""
    path = [edge]
    for pmap in parents:
        path.append(pmap[path[-1]])
    return tuple(path)


def _shared_level_params(specs: tuple[PolicySpec, ...], level: int) -> None:
    """A level's nodes step as one batch: they share kind, n_objects, window
    and the sketch options."""
    s0 = specs[0]
    for s in specs[1:]:
        if (s.kind, s.n_objects, s.window) != (s0.kind, s0.n_objects, s0.window):
            raise ValueError(
                f"level {level}: nodes must share kind/n_objects/window to "
                f"stack; got {s} vs {s0}"
            )
        if s0.kind in torch_cache.SKETCH_KINDS and (
            s.effective_sketch_width,
            s.effective_window,
            s.effective_refresh,
            s.effective_hot,
            s.doorkeeper,
        ) != (
            s0.effective_sketch_width,
            s0.effective_window,
            s0.effective_refresh,
            s0.effective_hot,
            s0.doorkeeper,
        ):
            # the batched step reads s0's sketch parameters, so nodes may
            # differ only in capacity
            raise ValueError(
                f"level {level}: sketch-policy nodes must share sketch_width/"
                f"window/refresh/hot_size/doorkeeper (got {s} vs {s0})"
            )


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static tier tree: ``levels[0]`` edges ... ``levels[-1]`` root tier.

    ``parents`` has one tuple per non-root level: ``parents[l][i]`` is the
    index (at level ``l+1``) of the tier that consumes node ``i``'s misses.
    ``level_names`` optionally labels levels for reports (defaults to
    ``edge / mid1 / ... / root``).

    ``placements`` names one cross-tier placement per level (``"lce"`` —
    leave-copy-everywhere, the default; ``"lcd"``; ``"prob(p)"``;
    ``"admit"`` — see :mod:`repro_torch.fleet.placement`); empty means
    all-lce, the topologies the level-major engine runs.

    ``routers`` optionally names one router kind per level: ``routers[0]``
    is the edge router (same as ``router``) and upper entries are either a
    :data:`repro_torch.cdn.router.ROUTER_MODES` kind — the tier partitions
    requests itself, e.g. sticky edges over hashed regionals — or the
    ``"tree"`` sentinel (follow the static parent map, the default).
    Empty normalises to ``(router, "tree", ..., "tree")``.
    """

    levels: tuple[tuple[PolicySpec, ...], ...]
    parents: tuple[tuple[int, ...], ...]
    router: str = "hash"
    session_len: int = 64
    level_names: tuple[str, ...] = ()
    placements: tuple[str, ...] = ()
    routers: tuple[str, ...] = ()

    def __post_init__(self):
        # the router comes in at call time: repro_torch.cdn imports this module (cdn.hierarchy)
        from repro_torch.cdn import router as router_mod

        if not self.levels or any(not lvl for lvl in self.levels):
            raise ValueError("topology needs at least one non-empty level")
        if len(self.parents) != len(self.levels) - 1:
            raise ValueError(
                f"need one parents tuple per non-root level: "
                f"{len(self.levels)} levels but {len(self.parents)} parent maps"
            )
        n0 = self.levels[0][0].n_objects
        for l, lvl in enumerate(self.levels):
            _shared_level_params(lvl, l)
            if lvl[0].n_objects != n0:
                raise ValueError("all levels must share n_objects")
        for l, pmap in enumerate(self.parents):
            if len(pmap) != len(self.levels[l]):
                raise ValueError(
                    f"parents[{l}] must map every node of level {l}: "
                    f"{len(pmap)} entries for {len(self.levels[l])} nodes"
                )
            hi = len(self.levels[l + 1])
            if any(not 0 <= p < hi for p in pmap):
                raise ValueError(f"parents[{l}] index out of range [0, {hi})")
        if self.level_names and len(self.level_names) != len(self.levels):
            raise ValueError("level_names must name every level")
        if self.router not in router_mod.ROUTER_MODES:
            raise ValueError(
                f"unknown router {self.router!r}; expected one of "
                f"{router_mod.ROUTER_MODES}"
            )
        L = len(self.levels)
        # normalise the per-level fields in place (frozen dataclass, hence
        # object.__setattr__) so equal trees hash equal however constructed
        if not self.placements:
            object.__setattr__(self, "placements", ("lce",) * L)
        if len(self.placements) != L:
            raise ValueError(
                f"placements must name every level: {len(self.placements)} "
                f"entries for {L} levels"
            )
        for p in self.placements:
            placement_mod.validate(p)
        if not self.routers:
            object.__setattr__(
                self, "routers", (self.router,) + (router_mod.TREE,) * (L - 1)
            )
        if len(self.routers) != L:
            raise ValueError(
                f"routers must name every level: {len(self.routers)} "
                f"entries for {L} levels"
            )
        if self.routers[0] == router_mod.TREE:
            raise ValueError("the edge level (routers[0]) cannot be 'tree'")
        for r in self.routers:
            if r not in router_mod.LEVEL_ROUTER_MODES:
                raise ValueError(
                    f"unknown level router {r!r}; expected one of "
                    f"{router_mod.LEVEL_ROUTER_MODES}"
                )
        # the edge entry is authoritative: keep the legacy scalar in sync
        object.__setattr__(self, "router", self.routers[0])

    # ------------------------------------------------------------ structure
    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def n_edges(self) -> int:
        return len(self.levels[0])

    @property
    def n_nodes(self) -> int:
        return sum(len(lvl) for lvl in self.levels)

    @property
    def n_objects(self) -> int:
        return self.levels[0][0].n_objects

    @property
    def names(self) -> tuple[str, ...]:
        if self.level_names:
            return self.level_names
        L = self.n_levels
        if L == 1:
            return ("edge",)
        return ("edge", *[f"mid{i}" for i in range(1, L - 1)], "root")

    def ancestry(self, edge: int) -> tuple[int, ...]:
        """Node index at every level on the miss path of ``edge``."""
        return ancestry_path(self.parents, edge)

    # ------------------------------------------------------------ placement
    @property
    def has_placement(self) -> bool:
        """Any level with a non-default (non-lce) placement: such trees need
        the time-major placed engine."""
        return any(p != "lce" for p in self.placements)

    @property
    def has_level_routers(self) -> bool:
        """Any non-edge level routed by kind instead of the parent map."""
        return any(r != "tree" for r in self.routers[1:])

    # -------------------------------------------------------------- routing
    def assignment(self, trace: np.ndarray, seed: int = 0) -> np.ndarray:
        """Route a (..., T) trace to edges (on the host, shared by the oracle
        and the fleet engine)."""
        from repro_torch.cdn import router as router_mod

        return router_mod.route(
            trace, self.n_edges, self.router, session_len=self.session_len,
            seed=seed,
        )


def level_assignments(topo: Topology, trace, assignment):
    """Per-level node assignment of every request: one int32 array per level,
    shaped like ``trace`` (numpy arrays, or torch tensors on the trace's
    device). Level 0 is the given edge ``assignment``; an upper level either
    follows the static parent map (``"tree"``, the assignment pushed up) or
    routes the request stream itself with its own router kind
    (:func:`repro_torch.cdn.router.route_level`, seeded by the level index).

    The numpy and torch results are bit-identical: the fleet engine and the
    pure-Python oracle both call this, which keeps routed levels exact."""
    from repro_torch.cdn import router as router_mod

    if isinstance(trace, torch.Tensor):
        outs = [torch.as_tensor(assignment, device=trace.device).to(torch.int32)]
        parent_map = lambda pmap: torch.as_tensor(pmap, dtype=torch.int32, device=trace.device)[outs[-1].long()]
    else:
        outs = [np.asarray(assignment, np.int32)]
        parent_map = lambda pmap: np.asarray(pmap, np.int32)[outs[-1]]
    for l, pmap in enumerate(topo.parents):
        mode = topo.routers[l + 1]
        if mode == router_mod.TREE:
            outs.append(parent_map(pmap))
        else:
            outs.append(router_mod.route_level(trace, len(topo.levels[l + 1]), mode, session_len=topo.session_len,
                                               seed=l + 1))
    return outs


def _per_level(value, n_levels: int, name: str) -> tuple:
    """Broadcast a scalar (or pass through a length-L sequence) per level."""
    if isinstance(value, (tuple, list)):
        if len(value) != n_levels:
            raise ValueError(f"{name} must have one entry per level ({n_levels})")
        return tuple(value)
    return (value,) * n_levels


def tree(
    n_objects: int,
    *,
    widths: Sequence[int],
    kinds: str | Sequence[str],
    capacities: int | Sequence[int],
    router: str = "hash",
    session_len: int = 64,
    window: int | Sequence[int] = 0,
    refresh: int | Sequence[int] = 0,
    sketch_width: int | Sequence[int] = 0,
    hot_size: int | Sequence[int] = 0,
    doorkeeper: int | Sequence[int] = 0,
    capacity_bytes: int | Sequence[int] = 0,
    max_victims: int | Sequence[int] = 0,
    level_names: Sequence[str] = (),
    placements: str | Sequence[str] = (),
    routers: Sequence[str] = (),
) -> Topology:
    """Symmetric tier tree: ``widths`` nodes per level (edges first), children
    spread contiguously over the level above, homogeneous capacity per level.

        topo = fleet.tree(n_objects=10_000, widths=(8, 2, 1),
                          kinds=("lru", "plfu", "plfu"),
                          capacities=(60, 240, 960))

    Per-level options (``kinds``/``capacities``/``window``/...) take either a
    scalar (applied to every level) or one value per level.
    """
    L = len(widths)
    if L < 1 or any(w < 1 for w in widths):
        raise ValueError(f"widths must be positive, got {widths}")
    kinds_l = _per_level(kinds, L, "kinds")
    caps_l = _per_level(capacities, L, "capacities")
    win_l = _per_level(window, L, "window")
    ref_l = _per_level(refresh, L, "refresh")
    sw_l = _per_level(sketch_width, L, "sketch_width")
    hot_l = _per_level(hot_size, L, "hot_size")
    cb_l = _per_level(capacity_bytes, L, "capacity_bytes")
    mv_l = _per_level(max_victims, L, "max_victims")
    # a broadcast scalar doorkeeper applies only to the tinylfu levels of a
    # mixed-kind tree (same filter as cdn.two_tier); an explicit per-level
    # sequence is passed through, so PolicySpec still rejects a doorkeeper
    # deliberately aimed at a non-tinylfu level
    dk_explicit = isinstance(doorkeeper, (tuple, list))
    dk_l = tuple(
        dk if (dk_explicit or kinds_l[l] == "tinylfu") else 0
        for l, dk in enumerate(_per_level(doorkeeper, L, "doorkeeper"))
    )
    levels = tuple(
        tuple(
            PolicySpec(
                kind=kinds_l[l], n_objects=n_objects, capacity=caps_l[l],
                hot_size=hot_l[l], window=win_l[l], refresh=ref_l[l],
                sketch_width=sw_l[l], doorkeeper=dk_l[l],
                capacity_bytes=cb_l[l], max_victims=mv_l[l],
            )
            for _ in range(widths[l])
        )
        for l in range(L)
    )
    parents = tuple(
        tuple(i * widths[l + 1] // widths[l] for i in range(widths[l]))
        for l in range(L - 1)
    )
    if isinstance(placements, str):
        placements = (placements,) * L
    return Topology(
        levels=levels, parents=parents, router=router,
        session_len=session_len, level_names=tuple(level_names),
        placements=tuple(placements), routers=tuple(routers),
    )


def from_hierarchy(hspec) -> Topology:
    """The depth-2 Topology of a :class:`repro_torch.cdn.HierarchySpec`: its
    edges under its one parent, all-lce."""
    return Topology(
        levels=(tuple(hspec.edges), (hspec.parent,)),
        parents=((0,) * len(hspec.edges),),
        router=hspec.router,
        session_len=hspec.session_len,
        level_names=("edge", "parent"),
    )
