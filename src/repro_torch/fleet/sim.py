"""The level-major N-tier fleet engine, on torch tensors.

The counterpart of the reference package's level-major engine. Every level
runs :func:`repro_torch.core.torch_cache.step` over the whole trace: node
``i`` at level ``l`` is *active* at position ``t`` iff the request is routed
to it (the edge assignment pushed up the parent tree, or the level's own
router) **and** no level below served it, so each tier consumes exactly the
interleaved miss stream of its children, in request order, and an inactive
node's state stays as it was.

A level's nodes, for all samples, are the rows of one batched state (row
``s * K + k`` is node ``k`` of sample ``s``). A node's state changes only at
its own requests, so each row runs through its own request stream: step
``j`` steps, in place, every row with more than ``j`` requests, which keeps
an inactive node frozen as the reference's ``where`` does, and a level takes
as many steps as its busiest node has requests rather than one per position.
plfua_dyn refreshes every node, active or not, after each whole refresh
period of *global* positions (a partial tail period never fires), as the
reference's chunked scan does: each refresh reaches a row between the same
two of its requests.

With a :class:`repro_torch.telemetry.TelemetrySpec` the engine records each
stepped row's events (fill, evictions, occupancy, tinylfu's aging, plfua_dyn's
refresh and churn, and per tenant group the victims and occupancy) and
buckets them per node into the windowed series; an inactive node's occupancy
is its last value, carried forward.

Topologies with a non-lce placement need the reference's time-major placed
engine, which is not ported yet (ROADMAP.md module 8): :func:`simulate_fleet`
raises ``NotImplementedError`` for them. The pure-Python oracle
(:mod:`repro_torch.fleet.reference`) runs the same topology request by request;
the tests hold the engine to it and to the reference package's engine, exactly.
On the card every step is a few dozen small kernel launches from the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import arange, resolve_device
from repro_torch.core import torch_cache
from repro_torch.core.torch_cache import PolicySpec
from repro_torch.fleet import topology as topo_mod
from repro_torch.fleet.topology import Topology
from repro_torch.telemetry import spec as telemetry_spec

__all__ = [
    "level_assignments",
    "level_series",
    "masked_scan",
    "run_level",
    "simulate_fleet",
    "simulate_fleet_batch",
    "stack_level_state",
    "tier_counters",
    "upper_levels",
]


def _streams(rows, active, r_n: int):
    """Each row's own request stream, from the ``(S, T)`` row and active
    series: every active request's ``(sample, position)`` grouped by row in
    position order (a row's requests are all one sample's), its step ``j``
    in its row's stream, and the rows by descending stream length (``perm``),
    so that the rows still stepping at step ``j`` are a prefix of that
    order; ``slot[r]`` is row ``r``'s place in it."""
    dev = rows.device
    s_idx, t_idx = torch.nonzero(active, as_tuple=True)
    row = rows[s_idx, t_idx].long()
    order = torch.argsort(row, stable=True)
    s_idx, t_idx, row = s_idx[order], t_idx[order], row[order]
    length = torch.bincount(row, minlength=r_n)
    perm = torch.argsort(length, descending=True, stable=True)
    slot = torch.empty_like(perm)
    slot[perm] = arange(r_n, dev)
    start = torch.cumsum(length, 0) - length
    j_idx = arange(row.shape[0], dev) - start[row]
    return s_idx, t_idx, row, j_idx, slot[row], perm, slot, length


def _refresh_schedule(t_idx, row, perm, r_n: int, t_n: int, refresh: int) -> dict:
    """plfua_dyn's refreshes on global time, in stream steps: refresh ``b``
    (from 0, after position ``(b + 1) * refresh - 1``) reaches a row after
    its requests up to that position. Returns ``{j: [(b, slots)]}``: the
    refreshes due before step ``j`` (after the last step at ``j = J``), in
    order, each with the rows' slots (see :func:`_streams`)."""
    n_fire = t_n // refresh
    if not n_fire:
        return {}
    # requests of each row in each period, then how many come before each period's end
    per = torch.zeros((r_n, n_fire + 1), dtype=torch.long, device=row.device)
    per.index_put_((row, torch.clamp(t_idx // refresh, max=n_fire)), torch.ones_like(row), accumulate=True)
    due = per[:, :n_fire].cumsum(dim=1)[perm].cpu().numpy()
    schedule: dict = {}
    for b in range(n_fire):
        for j in np.unique(due[:, b]).tolist():
            schedule.setdefault(j, []).append((b, np.flatnonzero(due[:, b] == j)))
    return schedule


def masked_scan(spec: PolicySpec, state: dict, traces, rows, active, cap=None, *, instrument=False, sizes=None,
                cap_bytes=None, gidx=None, n_groups=0):
    """Step a batched state of ``R`` rows over ``(S, T)`` traces: at position
    ``t`` sample ``s``'s request steps row ``rows[s, t]`` if ``active[s, t]``,
    and no row changes otherwise. ``cap``/``cap_bytes`` are ``None`` (the
    spec's) or ``(R,)`` per-row limits. Returns ``(state, hits (S, T))`` (the
    hits masked by ``active``), plus with ``instrument`` the events of each
    stepped row: ``fill``, ``evict``, ``count`` (the row's occupancy after the
    step), tinylfu's ``aging``, grouped ``evict_g``/``count_g`` (``gidx``, see
    ``torch_cache.group_scatter_arrays``) as ``(S, T[, G])`` tensors, valid
    where ``active``; and plfua_dyn's per-period ``fired`` ``(C,)`` and per-row
    ``churn`` ``(R, C)`` (``churn_g`` ``(R, C, G)``). The state returned is
    new; the one given is not changed.

    A row changes only at its own requests and at plfua_dyn's refreshes, so
    each row runs through its own request stream: step ``j`` steps every row
    with more than ``j`` requests, in place, as a prefix of the rows sorted
    by stream length. A level takes as many steps as its busiest row has
    requests, and a refresh reaches each row between the same two of its
    requests as on global time."""
    dev = traces.device
    s_n, t_n = traces.shape
    r_n = state["count"].shape[0]
    s_idx, t_idx, row, j_idx, col, perm, slot, length = _streams(rows, active, r_n)
    lengths = length[perm].cpu().numpy()
    j_n = int(lengths[0]) if r_n else 0
    # rows stepping at step j: those with more than j requests (lengths descend)
    live = np.searchsorted(-lengths, -np.arange(j_n), side="left").tolist()
    x_j = torch.zeros((j_n, r_n), dtype=torch.long, device=dev)
    x_j[j_idx, col] = traces[s_idx, t_idx].long()
    work = {k: v.index_select(0, perm) for k, v in state.items()}
    cap_j = None if cap is None else torch.as_tensor(cap, device=dev)[perm]
    cap_b_j = None if cap_bytes is None else torch.as_tensor(cap_bytes, device=dev)[perm]
    hits_j = torch.zeros((j_n, r_n), dtype=torch.bool, device=dev)
    refresh = spec.effective_refresh if spec.kind == "plfua_dyn" else 0
    schedule = _refresh_schedule(t_idx, row, perm, r_n, t_n, refresh) if refresh else {}
    ev_j = {}
    if instrument:
        buffer = lambda dtype, *shape: torch.zeros((j_n, r_n) + shape, dtype=dtype, device=dev)
        ev_j = {"fill": buffer(torch.bool), "evict": buffer(torch.int32), "count": buffer(torch.int32)}
        if spec.kind == "tinylfu":
            ev_j["aging"] = buffer(torch.bool)
        if gidx is not None:
            ev_j.update(evict_g=buffer(torch.int32, n_groups), count_g=buffer(torch.int32, n_groups))
        if refresh:
            n_chunks = -(-t_n // refresh)
            fired = torch.arange(n_chunks, device=dev) < t_n // refresh
            churn = torch.zeros((r_n, n_chunks), dtype=torch.int32, device=dev)
            if gidx is not None:
                churn_g = torch.zeros((r_n, n_chunks, n_groups), dtype=torch.int32, device=dev)
    for j in range(j_n + 1):
        for b, slots in schedule.get(j, ()):
            idx = torch.as_tensor(slots, device=dev)
            sub = {k: work[k].index_select(0, idx) for k in ("hot", "sketch")}
            old_hot = sub["hot"].clone() if instrument else None
            torch_cache.refresh_hot(spec, sub)
            for k, v in sub.items():
                work[k].index_copy_(0, idx, v)
            if instrument:
                diff = old_hot != sub["hot"]
                churn[idx, b] = diff.sum(dim=1, dtype=torch.int32)
                if gidx is not None:
                    churn_g[idx, b] = torch_cache._group_counts(diff, gidx, n_groups)
        if j == j_n:
            break
        m = live[j]
        sub = {k: v[:m] for k, v in work.items()}
        x = x_j[j, :m]
        if instrument:
            before = sub["count"].clone()
            before_in = sub["in_cache"].clone() if gidx is not None else None
        _, hit = torch_cache.step(spec, sub, x, None if cap_j is None else cap_j[:m], sizes=sizes,
                                  cap_bytes=None if cap_b_j is None else cap_b_j[:m])
        hits_j[j, :m] = hit
        if instrument:
            in_cache = sub["in_cache"]
            fill = ~hit & in_cache[arange(m, dev), x]
            ev = {"fill": fill, "evict": before - sub["count"] + fill, "count": sub["count"]}
            if spec.kind == "tinylfu":
                ev["aging"] = sub["seen"] == 0
            if gidx is not None:
                ev["evict_g"] = torch_cache._group_counts(before_in & ~in_cache, gidx, n_groups)
                ev["count_g"] = torch_cache._group_counts(in_cache, gidx, n_groups)
            for k, v in ev.items():
                ev_j[k][j, :m] = v
    out_state = {k: v.index_select(0, slot) for k, v in work.items()}

    def positions(v):
        """A ``(J, R[, G])`` stream-step series at each request's ``(s, t)``, 0 elsewhere."""
        out = v.new_zeros((s_n, t_n) + v.shape[2:])
        out[s_idx, t_idx] = v[j_idx, col]
        return out

    hits = positions(hits_j)
    if not instrument:
        return out_state, hits
    events = {k: positions(v) for k, v in ev_j.items()}
    if refresh:
        events.update(fired=fired, churn=churn.index_select(0, slot))
        if gidx is not None:
            events["churn_g"] = churn_g.index_select(0, slot)
    return out_state, hits, events


def tier_counters(spec: PolicySpec, hits, active, trace, state, sizes=None) -> dict:
    """Per-node accounting from the ``(..., K, T)`` hit and active series,
    the ``(..., T)`` trace and the final ``(..., K, ...)`` state, as int32
    ``(..., K)`` counters. Every admitted miss inserts, so evictions =
    inserts - final occupancy; the sketch kinds (and every kind in byte mode)
    carry their insert count in the state. With ``sizes`` the dict gains the
    ``req_bytes``/``hit_bytes`` traffic sums, and in byte mode the resident
    ``bytes``."""
    i32 = lambda v: v.to(torch.int32)
    total = lambda v: i32(v.sum(dim=-1))
    miss = active & ~hits
    count = state["count"]
    if spec.kind == "plfua":
        hot = state["hot"]
        # the hot mask gathered at each request
        admitted = torch.gather(hot, -1, trace.long().unsqueeze(-2).expand(hot.shape[:-1] + trace.shape[-1:]))
        inserts = state["inserts"] if spec.capacity_bytes else total(miss & admitted)
        admitted_requests = total(active & admitted)
    elif spec.kind in torch_cache.SKETCH_KINDS:
        inserts = state["inserts"]
        # every hit touches the policy's metadata, and every insert is an admitted miss
        admitted_requests = total(hits) + inserts
    else:
        inserts = state["inserts"] if spec.capacity_bytes else total(miss)
        admitted_requests = total(active)
    out = {
        "requests": total(active),
        "hits": total(hits),
        "admitted_requests": i32(admitted_requests),
        "inserts": i32(inserts),
        "evictions": i32(inserts - count),
        "count": count,
    }
    if sizes is not None:
        sz_t = sizes[trace.long()].unsqueeze(-2)
        out["req_bytes"] = total(active * sz_t)
        out["hit_bytes"] = total(hits * sz_t)
    if spec.capacity_bytes:
        out["bytes"] = state["bytes"]
    return out


def level_assignments(topo: Topology, trace: torch.Tensor, assignment: torch.Tensor) -> list[torch.Tensor]:
    """Per-level node assignment of every request, int32 shaped like ``trace``
    (see :func:`repro_torch.fleet.topology.level_assignments`)."""
    return topo_mod.level_assignments(topo, trace, assignment)


def stack_level_state(specs: tuple[PolicySpec, ...], n_samples: int | None = None, device=None) -> dict:
    """Zero state of one level's nodes, stacked: ``(K, ...)``, or ``(S, K,
    ...)`` with ``n_samples``. Each node starts from its own spec (a plfua
    node's hot set follows its own capacity)."""
    dev = resolve_device(device)
    nodes = [torch_cache.init_state(s, n_samples, device=dev) for s in specs]
    dim = 0 if n_samples is None else 1
    return {k: torch.stack([n[k] for n in nodes], dim=dim) for k in nodes[0]}


def _carry_forward(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``(S, T[, G])`` values of the stepped rows -> ``(S, K, T[, G])``: node
    ``k``'s value at ``t`` is the one of its last step at or before ``t``
    (``mask``: ``(S, K, T)``, the node's steps), 0 before its first."""
    t_n = mask.shape[-1]
    last = torch.where(mask, torch.arange(t_n, device=mask.device), -1).cummax(dim=-1).values
    idx = last.clamp(min=0)
    src = values.unsqueeze(1).expand(mask.shape + values.shape[2:])
    if values.dim() == 3:
        idx = idx.unsqueeze(-1).expand(src.shape)
        last = last.unsqueeze(-1)
    return torch.where(last >= 0, torch.gather(src, 2, idx), 0)


def _node_events(events: dict, node_active, k_n: int) -> dict:
    """The stepped rows' events as each node's ``(S, K, T[, G])`` series, zero
    where the node is inactive, occupancy carried forward; plfua_dyn's
    per-period events as ``(S, K, C[, G])``."""
    s_n = node_active.shape[0]
    masked = lambda v: torch.where(node_active.view(node_active.shape + (1,) * (v.dim() - 2)), v.unsqueeze(1), 0)
    out = {"fill": node_active & events["fill"].unsqueeze(1), "evict": masked(events["evict"]),
           "count": _carry_forward(events["count"], node_active)}
    if "aging" in events:
        out["aging"] = node_active & events["aging"].unsqueeze(1)
    if "evict_g" in events:
        out["evict_g"] = masked(events["evict_g"])
        out["count_g"] = _carry_forward(events["count_g"], node_active)
    if "fired" in events:
        out["fired"] = events["fired"].expand(s_n, k_n, -1)
        out["churn"] = events["churn"].view(s_n, k_n, -1)
        if "churn_g" in events:
            out["churn_g"] = events["churn_g"].view(s_n, k_n, *events["churn_g"].shape[1:])
    return out


def run_level(specs: tuple[PolicySpec, ...], traces, assign, demand, *, instrument=False, sizes=None, gidx=None,
              n_groups=0):
    """One level over ``(S, T)`` traces: ``assign`` is each request's node at
    this level and ``demand`` whether it reaches the level (unserved below).
    Returns ``(states (S, K, ...), node hits (S, K, T), node active (S, K,
    T))``, plus with ``instrument`` each node's events (see
    :func:`masked_scan`)."""
    s0 = specs[0]
    k_n = len(specs)
    s_n = traces.shape[0]
    dev = traces.device
    state = {k: v.flatten(0, 1) for k, v in stack_level_state(specs, s_n, dev).items()}
    rows = arange(s_n, dev)[:, None] * k_n + assign.long()
    caps = [s.capacity for s in specs]
    cap = None if len(set(caps)) == 1 else torch.tensor(caps * s_n, dtype=torch.int32, device=dev)
    cap_bytes = None
    if s0.capacity_bytes and len({s.capacity_bytes for s in specs}) > 1:
        cap_bytes = torch.tensor([s.capacity_bytes for s in specs] * s_n, dtype=torch.int32, device=dev)
    out = masked_scan(s0, state, traces, rows, demand, cap, instrument=instrument, sizes=sizes,
                      cap_bytes=cap_bytes, gidx=gidx, n_groups=n_groups)
    states = {k: v.view((s_n, k_n) + v.shape[1:]) for k, v in out[0].items()}
    node_active = (assign.unsqueeze(1) == arange(k_n, dev)[:, None]) & demand.unsqueeze(1)
    node_hits = node_active & out[1].unsqueeze(1)
    if not instrument:
        return states, node_hits, node_active
    return states, node_hits, node_active, _node_events(out[2], node_active, k_n)


def level_series(spec: PolicySpec, telemetry, trace_len: int, hits, active, events: dict, groups_t=None):
    """Bucket one level's node events into ``(S, K, n_windows, N_METRICS)``
    (a group axis before N_METRICS when ``telemetry.n_groups > 0``): the
    level-major engine has no placement gate, so every miss of an active node
    is a fill offer."""
    if groups_t is not None:
        groups_t = groups_t.unsqueeze(-2)
    return torch_cache.telemetry_series(spec, telemetry, trace_len, hits, events, groups_t=groups_t, active=active)


def _level_byte_events(events: dict, hits, active, sz_t) -> None:
    """The level's hit and miss bytes, from the trace's sizes ``(S, T)``."""
    sz = sz_t.unsqueeze(1)
    events["hit_bytes"] = torch.where(hits, sz, 0)
    events["miss_bytes"] = torch.where(active & ~hits, sz, 0)


def upper_levels(topo: Topology, traces, assigns, demand, *, telemetry=None, sizes=None, gidx=None, groups_t=None):
    """Run levels 1..L-1 given the edge tier's surviving ``demand`` ``(S, T)``.
    Returns (per-level node hits, counters, states, demand[, per-level series
    when ``telemetry`` is set, and for a grouped run the per-level eviction
    pressure])."""
    instrument = telemetry is not None
    grouped = instrument and telemetry.n_groups > 0
    level_hits, counters, states_out, series_out, pressure_out = [], [], [], [], []
    for l in range(1, topo.n_levels):
        specs = topo.levels[l]
        out = run_level(specs, traces, assigns[l], demand, instrument=instrument, sizes=sizes, gidx=gidx,
                        n_groups=telemetry.n_groups if instrument else 0)
        states, hits, active = out[:3]
        if instrument:
            events = out[3]
            if sizes is not None:
                _level_byte_events(events, hits, active, sizes[traces.long()])
            series_out.append(level_series(specs[0], telemetry, traces.shape[-1], hits, active, events, groups_t))
            if grouped:
                pressure_out.append(telemetry_spec.windowed_pressure(telemetry.window, groups_t.unsqueeze(-2),
                                                                     events["evict_g"]))
        level_hits.append(hits)
        counters.append(tier_counters(specs[0], hits, active, traces, states, sizes))
        states_out.append(states)
        demand = demand & ~hits.any(dim=1)
    if grouped:
        return level_hits, counters, states_out, demand, series_out, pressure_out
    if instrument:
        return level_hits, counters, states_out, demand, series_out
    return level_hits, counters, states_out, demand


def _simulate_fleet_impl(topo: Topology, traces, assignments, telemetry=None, sizes=None, groups=None,
                         device=None) -> dict:
    if topo.has_placement:
        raise NotImplementedError(
            f"placements {topo.placements}: a non-lce placement needs the time-major placed engine, which is "
            "not ported yet (ROADMAP.md module 8); the level-major engine runs all-lce topologies only")
    if telemetry is not None and not isinstance(telemetry, telemetry_spec.TelemetrySpec):
        raise TypeError(f"telemetry must be a TelemetrySpec or None, got {type(telemetry).__name__}")
    dev = resolve_device(device)
    traces = torch.as_tensor(traces, device=dev).to(torch.int32)
    assignments = torch.as_tensor(assignments, device=dev).to(torch.int32)
    if traces.ndim != 2 or assignments.shape != traces.shape:
        raise ValueError(f"traces and assignments must be (S, T) alike, got {tuple(traces.shape)} and "
                         f"{tuple(assignments.shape)}")
    if sizes is not None:
        sizes = torch.as_tensor(sizes, device=dev).to(torch.int32)
        if tuple(sizes.shape) != (topo.n_objects,):
            raise ValueError(f"sizes must have shape ({topo.n_objects},), got {tuple(sizes.shape)}")
    gidx, groups_t = torch_cache.group_scatter_arrays(telemetry, groups, traces)
    grouped = gidx is not None
    assigns = level_assignments(topo, traces, assignments)
    instrument = telemetry is not None
    specs0 = topo.levels[0]
    edge_demand = torch.ones_like(traces, dtype=torch.bool)
    out0 = run_level(specs0, traces, assigns[0], edge_demand, instrument=instrument, sizes=sizes, gidx=gidx,
                     n_groups=telemetry.n_groups if instrument else 0)
    edge_states, edge_hits, active0 = out0[:3]
    demand = ~edge_hits.any(dim=1)
    upper = upper_levels(topo, traces, assigns, demand, telemetry=telemetry, sizes=sizes, gidx=gidx,
                         groups_t=groups_t)
    hits_up, counters_up, states_up, demand = upper[:4]
    all_hits = [edge_hits, *hits_up]
    out = {
        # (S, T) bool per level: request served at this level
        "hit": tuple(h.any(dim=1) for h in all_hits),
        # (S, K_l, T) bool per level: which node served it
        "node_hit": tuple(all_hits),
        # per-level counter dicts of (S, K_l) int32
        "tiers": (tier_counters(specs0[0], edge_hits, active0, traces, edge_states, sizes), *counters_up),
        # per-level stacked final states, (S, K_l, ...)
        "states": (edge_states, *states_up),
        # (S, T) bool: missed every tier, fetched from the origin
        "origin_miss": demand,
    }
    if instrument:
        events0 = out0[3]
        if sizes is not None:
            _level_byte_events(events0, edge_hits, active0, sizes[traces.long()])
        edge_series = level_series(specs0[0], telemetry, traces.shape[-1], edge_hits, active0, events0, groups_t)
        # (S, K_l, n_windows[, n_groups], N_METRICS) int32 per level
        out["telemetry"] = (edge_series, *upper[4])
        if grouped:
            # per level (S, K_l, n_windows, n_groups): evictions of each group's objects at steps
            # requested by another group (cross-tenant eviction pressure)
            edge_pressure = telemetry_spec.windowed_pressure(telemetry.window, groups_t.unsqueeze(-2),
                                                             events0["evict_g"])
            out["telemetry_pressure"] = (edge_pressure, *upper[5])
    return out


def _map(fn, tree):
    """Apply ``fn`` to every tensor of a result's nested tuples and dicts."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def simulate_fleet(topo: Topology, trace, assignment, telemetry=None, sizes=None, groups=None, *, device=None) -> dict:
    """Run one ``(T,)`` trace, routed by ``assignment`` (``(T,)`` edge ids,
    e.g. ``topo.assignment(trace)``), through an all-lce N-tier topology on
    ``device`` (the card unless ``"cpu"``). Returns a dict of tensors:

      ``hit``         tuple per level, (T,) bool — served at this level
      ``node_hit``    tuple per level, (K_l, T) bool — per-node hit series
      ``tiers``       tuple per level of int32 counter dicts (requests/hits/
                      admitted_requests/inserts/evictions/count, (K_l,);
                      plus req_bytes/hit_bytes when ``sizes`` is given and
                      resident ``bytes`` for byte-capacity levels)
      ``states``      tuple per level of the stacked final policy states
      ``origin_miss`` (T,) bool — missed every tier

    ``sizes`` is the shared ``(n_objects,)`` int32 byte catalogue. With a
    :class:`repro_torch.telemetry.TelemetrySpec` the dict gains
    ``telemetry``: per level a (K_l, n_windows, N_METRICS) int32 series, or
    (K_l, n_windows, n_groups, N_METRICS) for a grouped spec with its
    ``groups`` id -> group catalogue, which also adds ``telemetry_pressure``
    (K_l, n_windows, n_groups): a tenant's objects evicted by another
    tenant's requests. Raises ``NotImplementedError`` for a topology with a
    non-lce placement (ROADMAP.md module 8)."""
    trace = torch.as_tensor(trace)
    out = _simulate_fleet_impl(topo, trace[None], torch.as_tensor(assignment)[None], telemetry, sizes, groups,
                               device)
    return _map(lambda v: v[0], out)


def simulate_fleet_batch(topo: Topology, traces, assignments, telemetry=None, sizes=None, groups=None, *,
                         device=None) -> dict:
    """:func:`simulate_fleet` over ``(S, T)`` trace samples, batched: every
    output gains a leading sample axis (``sizes``/``groups`` are shared, one
    object universe)."""
    return _simulate_fleet_impl(topo, traces, assignments, telemetry, sizes, groups, device)
