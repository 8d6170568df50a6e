"""Pure-Python N-tier reference oracle: the ground truth for the fleet engine.

The port's copy of the reference package's oracle. Builds every topology node
from the paper-faithful policy objects in :mod:`repro_torch.core.policies` and
processes requests strictly in trace order: request -> assigned node per level
(the edge assignment pushed up the parent tree, or each level's own router —
the same :func:`repro_torch.fleet.topology.level_assignments` the engine
uses); the miss path is probed bottom-up to find the serving level, then every
consulted tier applies its fill-gated update, with ``lce`` / ``lcd`` /
``prob(p)`` / ``admit`` cross-tier placement as
:mod:`repro_torch.fleet.placement` defines it. Dynamic-PLFUA nodes refresh on
*global* time (one timer per node, fired every ``effective_refresh`` trace
positions), as the engine does. The tests hold the engine to it decision for
decision: per-level hit sequences, final cache contents, per-node hits and
evictions.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import policies, sketch
from repro_torch.core.torch_cache import PolicySpec
from repro_torch.fleet import placement as placement_mod
from repro_torch.fleet import topology as topo_mod
from repro_torch.fleet.topology import Topology

__all__ = [
    "build_policy",
    "cache_count",
    "peek_victim",
    "simulate_fleet_reference",
    "FleetReferenceResult",
]


def build_policy(spec: PolicySpec, sizes=None) -> policies.CachePolicy:
    """PolicySpec -> the equivalent reference policy object. ``sizes`` is the
    shared per-object byte catalogue (None = unit sizes), paired with the
    spec's ``capacity_bytes``/``max_victims`` byte-mode options."""
    bkw = dict(
        sizes=None if sizes is None else np.asarray(sizes),
        capacity_bytes=spec.capacity_bytes,
        max_victims=spec.max_victims,
    )
    if spec.kind == "lru":
        return policies.LRUCache(spec.capacity, **bkw)
    if spec.kind == "lfu":
        return policies.LFUCache(spec.capacity, **bkw)
    if spec.kind == "plfu":
        return policies.PLFUCache(spec.capacity, **bkw)
    if spec.kind == "plfua":
        return policies.PLFUACache(spec.capacity, hot=range(spec.effective_hot), **bkw)
    if spec.kind == "wlfu":
        return policies.WLFUCache(spec.capacity, window=spec.window, **bkw)
    if spec.kind == "tinylfu":
        return policies.TinyLFUCache(
            spec.capacity,
            window=spec.effective_window,
            sketch_width=spec.effective_sketch_width,
            doorkeeper=spec.doorkeeper,
            **bkw,
        )
    if spec.kind == "plfua_dyn":
        return policies.DynamicPLFUACache(
            spec.capacity,
            spec.n_objects,
            hot_size=spec.effective_hot,
            refresh=spec.effective_refresh,
            sketch_width=spec.effective_sketch_width,
            **bkw,
        )
    if spec.kind == "gdsf":
        return policies.GDSFCache(spec.capacity, n_objects=spec.n_objects, **bkw)
    if spec.kind == "arc":
        return policies.ARCCache(spec.capacity, **bkw)
    raise ValueError(f"no reference policy for kind {spec.kind!r}")


@dataclasses.dataclass
class FleetReferenceResult:
    level_hit: list[np.ndarray]  # per level: (T,) bool — served at this level
    levels: list[list[policies.CachePolicy]]  # per-node policy objects

    def in_cache(self, n_objects: int) -> list[np.ndarray]:
        """Final contents per level: (K_l, n_objects) bool."""
        return [
            np.array([[p.contains(i) for i in range(n_objects)] for p in lvl])
            for lvl in self.levels
        ]


def cache_count(pol: policies.CachePolicy) -> int:
    """Number of cached objects (the policy-side ``count``)."""
    if isinstance(pol, policies.LRUCache):
        return len(pol._od)
    if isinstance(pol, (policies.PLFUACache, policies.DynamicPLFUACache)):
        return len(pol._plfu._freq)
    if isinstance(pol, policies.WLFUCache):
        return len(pol._cache)
    if isinstance(pol, policies.ARCCache):
        return len(pol._t1) + len(pol._t2)
    return len(pol._freq)  # the _HeapLFUBase family


def peek_victim(pol: policies.CachePolicy) -> int:
    """The eviction candidate *without* evicting, with the fleet engine's
    tie-breaking (min key, then lowest id) — the object the admit placement
    duels against. Only meaningful when the cache is non-empty."""
    if isinstance(pol, policies.LRUCache):
        return next(iter(pol._od))  # front of the recency order
    if isinstance(pol, (policies.PLFUACache, policies.DynamicPLFUACache)):
        f = pol._plfu._freq
        return min(f, key=lambda o: (f[o], o))
    if isinstance(pol, policies.WLFUCache):
        wf = pol._wfreq
        return min(pol._cache, key=lambda o: (wf.get(o, 0), o))
    if isinstance(pol, policies.GDSFCache):
        s = pol._score
        return min(s, key=lambda o: (s[o], o))
    if isinstance(pol, policies.ARCCache):
        # the LRU of the list REPLACE would demote, under the placed engine's
        # x-independent pre-state pick (the |T1| == p B2-hit tiebreak is
        # dropped); OrderedDict front == list LRU
        prefer_t1 = len(pol._t1) > pol.p or not pol._t2
        return next(iter(pol._t1 if prefer_t1 else pol._t2))
    f = pol._freq
    return min(f, key=lambda o: (f[o], o))


def simulate_fleet_reference(
    topo: Topology, trace: np.ndarray, assignment: np.ndarray, sizes=None
) -> FleetReferenceResult:
    pols = [[build_policy(s, sizes) for s in lvl] for lvl in topo.levels]
    # dynamic-PLFUA refreshes run on *global* time in a fleet (one timer per
    # node), as the engine's do: switch the policy objects to externally
    # driven refresh and fire them on the tier cadence
    timers: list[tuple[policies.DynamicPLFUACache, int]] = []
    for lvl, specs in zip(pols, topo.levels):
        for pol, spec in zip(lvl, specs):
            if isinstance(pol, policies.DynamicPLFUACache):
                pol.external_refresh = True
                timers.append((pol, spec.effective_refresh))
    parsed = [placement_mod.parse(p) for p in topo.placements]
    # admit placement: one count-min sketch + aging counter per node
    admit_state: dict[int, list[dict]] = {}
    for l, (pk, _) in enumerate(parsed):
        if pk == "admit":
            width, window = placement_mod.admit_params(topo.levels[l])
            admit_state[l] = [
                {"sk": sketch.CountMinSketch(width), "seen": 0, "window": window}
                for _ in topo.levels[l]
            ]
    T = len(trace)
    L = topo.n_levels
    assigns = [
        a.tolist()
        for a in topo_mod.level_assignments(topo, np.asarray(trace), np.asarray(assignment))
    ]
    level_hit = [np.zeros(T, bool) for _ in range(L)]
    for t, x in enumerate(np.asarray(trace).tolist()):
        nodes = [assigns[l][t] for l in range(L)]
        # probe the miss path bottom-up (pre-update membership); serve == L
        # means origin
        serve = L
        for l in range(L):
            if pols[l][nodes[l]].contains(x):
                serve = l
                break
        # every consulted tier (through the serving one) updates, with the
        # level's placement gating insertion on the tiers that missed
        for l in range(min(serve, L - 1) + 1):
            node = nodes[l]
            pol = pols[l][node]
            pk, pp = parsed[l]
            fill = True
            if pk == "admit":
                a = admit_state[l][node]
                a["sk"].add(x)
                a["seen"] += 1
                if a["seen"] >= a["window"]:
                    a["sk"].halve()
                    a["seen"] = 0
                spec = topo.levels[l][node]
                if spec.capacity_bytes:
                    # byte mode: "full" = does not fit as-is (cf. tinylfu)
                    full = pol.bytes + pol._size(x) > spec.capacity_bytes
                else:
                    full = cache_count(pol) >= spec.capacity
                if l < serve and full:
                    v = peek_victim(pol)
                    fill = a["sk"].estimate(x) > a["sk"].estimate(v)
            elif l < serve:
                if pk == "lcd":
                    fill = serve == l + 1
                elif pk == "prob":
                    fill = serve == l + 1 or bool(
                        placement_mod.prob_fill(t, l, pp)
                    )
            if pol.request(x, fill=fill):
                level_hit[l][t] = True
        for pol, period in timers:
            if (t + 1) % period == 0:
                pol.refresh_now()
    return FleetReferenceResult(level_hit, pols)
