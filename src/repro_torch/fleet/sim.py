"""The N-tier fleet engines, on torch tensors.

The counterpart of the reference package's fleet simulator. Two engines,
picked by the topology:

* **Level-major** (all-lce placements). Every level runs
  :func:`repro_torch.core.torch_cache.step` over the whole trace: node ``i``
  at level ``l`` is *active* at position ``t`` iff the request is routed to it
  (the edge assignment pushed up the parent tree, or the level's own router)
  **and** no level below served it, so each tier consumes exactly the
  interleaved miss stream of its children, in request order, and an inactive
  node's state stays as it was. A level's nodes, for all samples, are the rows
  of one batched state (row ``s * K + k`` is node ``k`` of sample ``s``). A
  node's state changes only at its own requests, so each row runs through its
  own request stream: step ``j`` steps, in place, every row with more than
  ``j`` requests, and a level takes as many steps as its busiest node has
  requests rather than one per position. plfua_dyn refreshes every node,
  active or not, after each whole refresh period of *global* positions (a
  partial tail period never fires): each refresh reaches a row between the
  same two of its requests.

* **Time-major** (any non-lce placement, :mod:`repro_torch.fleet.placement`).
  A tier's insert decision depends on where the request was served above it,
  which is known only after the upper tiers' hit tests at the same position,
  so the levels no longer run one after the other. The placed engine runs
  *time*: at each position it probes the miss path bottom-up on the
  pre-update membership, then steps the one consulted node of each level,
  gathered from the level's rows, with the level's fill gate, and writes it
  back only where the request reached the level (an unconsulted node stays
  bit for bit as it was). It runs in chunks of the gcd of the plfua_dyn
  levels' refresh periods and refreshes a level at a chunk boundary that is a
  whole multiple of its own period. Levels whose specs step alike (a tree of
  one kind) step as one batch of rows. Nothing in the per-position body waits
  for the device; on the card each position is tens to hundreds of small
  kernel launches from the host. ``prob(1.0)`` reproduces the level-major
  engine bit for bit.

With a :class:`repro_torch.telemetry.TelemetrySpec` both engines record the
events of each step (fill, evictions, occupancy, tinylfu's aging, plfua_dyn's
refresh and churn, and per tenant group the victims and occupancy; the placed
engine also its fill offers, the consulted misses whose gate was open) and
bucket them per node into the windowed series.

The pure-Python oracle (:mod:`repro_torch.fleet.reference`) runs the same
topology request by request; the tests hold both engines to it and to the
reference package's engines, exactly.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._device import arange, resolve_device
from repro_torch.core import sketch, torch_cache
from repro_torch.core.torch_cache import PolicySpec
from repro_torch.fleet import placement as placement_mod
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


def _refresh_schedule(t_idx, row, perm, r_n: int, c_len: int, fires: list) -> dict:
    """plfua_dyn's refreshes on global time, in stream steps: the refresh
    after refresh chunk ``c`` (positions of chunks of ``c_len``; ``fires[c]``
    says whether it refreshes) reaches a row after its requests in chunks up
    to ``c``. Returns ``{j: [(c, slots)]}``: the refreshes due before step
    ``j`` (after the last step at ``j = J``), in order, each with the rows'
    slots (see :func:`_streams`)."""
    fired = [c for c, f in enumerate(fires) if f]
    if not fired:
        return {}
    # requests of each row between two refreshes, then how many come before each refresh
    ends = torch.as_tensor([(c + 1) * c_len for c in fired], device=row.device)
    per = torch.zeros((r_n, len(fired) + 1), dtype=torch.long, device=row.device)
    per.index_put_((row, torch.searchsorted(ends, t_idx, right=True)), torch.ones_like(row), accumulate=True)
    due = per[:, :len(fired)].cumsum(dim=1)[perm].cpu().numpy()
    schedule: dict = {}
    for b, c in enumerate(fired):
        for j in np.unique(due[:, b]).tolist():
            schedule.setdefault(j, []).append((c, np.flatnonzero(due[:, b] == j)))
    return schedule


def refresh_chunks(spec: PolicySpec, t_n: int, t0=None) -> tuple[int, list]:
    """plfua_dyn's refresh chunks over ``t_n`` positions: their length and
    whether each fires (``torch_cache.refresh_fires``). A bounded run
    (``t0=None``) takes whole refresh periods from position 0; a stream
    chunk whose global start is ``t0`` takes :func:`torch_cache
    .stream_sub_len` sub-chunks."""
    refresh = spec.effective_refresh
    c_len = refresh if t0 is None else torch_cache.stream_sub_len(spec, t_n)
    return c_len, torch_cache.refresh_fires(refresh, c_len, t_n, t0 or 0)


def masked_scan(spec: PolicySpec, state: dict, traces, rows, active, cap=None, *, instrument=False, sizes=None,
                cap_bytes=None, gidx=None, n_groups=0, t0=None):
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
    requests as on global time. ``t0`` makes the traces one chunk of a
    stream starting at that global position: plfua_dyn then refreshes, and
    emits its per-chunk events, on :func:`refresh_chunks`' sub-chunks."""
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
    refresh = spec.kind == "plfua_dyn"
    if refresh:
        c_len, fires = refresh_chunks(spec, t_n, t0)
        schedule = _refresh_schedule(t_idx, row, perm, r_n, c_len, fires)
    else:
        schedule = {}
    ev_j = {}
    if instrument:
        buffer = lambda dtype, *shape: torch.zeros((j_n, r_n) + shape, dtype=dtype, device=dev)
        ev_j = {"fill": buffer(torch.bool), "evict": buffer(torch.int32), "count": buffer(torch.int32)}
        if spec.kind == "tinylfu":
            ev_j["aging"] = buffer(torch.bool)
        if gidx is not None:
            ev_j.update(evict_g=buffer(torch.int32, n_groups), count_g=buffer(torch.int32, n_groups))
        if refresh:
            n_chunks = len(fires)
            fired = torch.as_tensor(fires, dtype=torch.bool, device=dev)
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


def _carry_forward(values: torch.Tensor, mask: torch.Tensor, init=None) -> torch.Tensor:
    """``(S, T[, G])`` values of the stepped rows -> ``(S, K, T[, G])``: node
    ``k``'s value at ``t`` is the one of its last step at or before ``t``
    (``mask``: ``(S, K, T)``, the node's steps), before its first ``init``
    (``(S, K[, G])``, a stream chunk's starting value) or 0."""
    t_n = mask.shape[-1]
    last = torch.where(mask, torch.arange(t_n, device=mask.device), -1).cummax(dim=-1).values
    idx = last.clamp(min=0)
    src = values.unsqueeze(1).expand(mask.shape + values.shape[2:])
    if values.dim() == 3:
        idx = idx.unsqueeze(-1).expand(src.shape)
        last = last.unsqueeze(-1)
    before = 0 if init is None else init.unsqueeze(2)
    return torch.where(last >= 0, torch.gather(src, 2, idx), before)


def _node_events(events: dict, node_active, k_n: int, init=None) -> dict:
    """The stepped rows' events as each node's ``(S, K, T[, G])`` series, zero
    where the node is inactive, occupancy carried forward (from ``init``'s
    ``count``/``count_g`` where given); plfua_dyn's per-period events as
    ``(S, K, C[, G])``."""
    s_n = node_active.shape[0]
    init = init or {}
    masked = lambda v: torch.where(node_active.view(node_active.shape + (1,) * (v.dim() - 2)), v.unsqueeze(1), 0)
    out = {"fill": node_active & events["fill"].unsqueeze(1), "evict": masked(events["evict"]),
           "count": _carry_forward(events["count"], node_active, init.get("count"))}
    if "aging" in events:
        out["aging"] = node_active & events["aging"].unsqueeze(1)
    if "evict_g" in events:
        out["evict_g"] = masked(events["evict_g"])
        out["count_g"] = _carry_forward(events["count_g"], node_active, init.get("count_g"))
    if "fired" in events:
        out["fired"] = events["fired"].expand(s_n, k_n, -1)
        out["churn"] = events["churn"].view(s_n, k_n, -1)
        if "churn_g" in events:
            out["churn_g"] = events["churn_g"].view(s_n, k_n, *events["churn_g"].shape[1:])
    return out


def run_level(specs: tuple[PolicySpec, ...], traces, assign, demand, *, instrument=False, sizes=None, gidx=None,
              n_groups=0, state=None, t0=None):
    """One level over ``(S, T)`` traces: ``assign`` is each request's node at
    this level and ``demand`` whether it reaches the level (unserved below).
    Returns ``(states (S, K, ...), node hits (S, K, T), node active (S, K,
    T))``, plus with ``instrument`` each node's events (see
    :func:`masked_scan`). The level starts from zero, or from ``state``
    (``(S, K, ...)``, left as it is) at the global position ``t0`` of a
    stream (see :func:`masked_scan`)."""
    s0 = specs[0]
    k_n = len(specs)
    s_n = traces.shape[0]
    dev = traces.device
    if state is None:
        state = stack_level_state(specs, s_n, dev)
    init = None
    if instrument and t0 is not None:
        init = {"count": state["count"]}
        if gidx is not None:
            init["count_g"] = torch_cache._group_counts(state["in_cache"].flatten(0, 1), gidx, n_groups).view(
                s_n, k_n, n_groups)
    state = {k: v.flatten(0, 1) for k, v in state.items()}
    rows = arange(s_n, dev)[:, None] * k_n + assign.long()
    caps = [s.capacity for s in specs]
    cap = None if len(set(caps)) == 1 else torch.tensor(caps * s_n, dtype=torch.int32, device=dev)
    cap_bytes = None
    if s0.capacity_bytes and len({s.capacity_bytes for s in specs}) > 1:
        cap_bytes = torch.tensor([s.capacity_bytes for s in specs] * s_n, dtype=torch.int32, device=dev)
    out = masked_scan(s0, state, traces, rows, demand, cap, instrument=instrument, sizes=sizes,
                      cap_bytes=cap_bytes, gidx=gidx, n_groups=n_groups, t0=t0)
    states = {k: v.view((s_n, k_n) + v.shape[1:]) for k, v in out[0].items()}
    node_active = (assign.unsqueeze(1) == arange(k_n, dev)[:, None]) & demand.unsqueeze(1)
    node_hits = node_active & out[1].unsqueeze(1)
    if not instrument:
        return states, node_hits, node_active
    return states, node_hits, node_active, _node_events(out[2], node_active, k_n, init)


def level_series(spec: PolicySpec, telemetry, trace_len: int, hits, active, events: dict, groups_t=None,
                 chunk_len=None):
    """Bucket one level's node events into ``(S, K, n_windows, N_METRICS)``
    (a group axis before N_METRICS when ``telemetry.n_groups > 0``): the
    level-major engine has no placement gate, so every miss of an active node
    is a fill offer. ``chunk_len`` is plfua_dyn's refresh chunk (the period
    when ``None``; a stream's sub-chunk)."""
    if groups_t is not None:
        groups_t = groups_t.unsqueeze(-2)
    return torch_cache.telemetry_series(spec, telemetry, trace_len, hits, events, groups_t=groups_t, active=active,
                                        chunk_len=chunk_len)


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


def _check_inputs(topo: Topology, traces, assignments, telemetry, sizes, device):
    """The call's traces, assignments and sizes as int32 tensors on its device (the card unless
    ``device="cpu"``). Raises on a wrong type or shape."""
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
    return traces, assignments, sizes


def _simulate_fleet_impl(topo: Topology, traces, assignments, telemetry=None, sizes=None, groups=None,
                         device=None) -> dict:
    traces, assignments, sizes = _check_inputs(topo, traces, assignments, telemetry, sizes, device)
    if topo.has_placement:
        # a non-lce placement couples the levels at each position: the time-major engine
        return _simulate_placed_impl(topo, traces, assignments, telemetry, sizes, groups)
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


# ------------------------------------------------- time-major placed engine
def _victim_key(spec: PolicySpec, state: dict) -> torch.Tensor:
    """The ``(S, N)`` key whose masked argmin is each node's eviction candidate,
    from the pre-request state: recency stamps for lru, the cached priority for
    gdsf, arc's stamps on the list REPLACE would demote, (windowed, parked)
    frequency for the rest. The admit placement duels against it (the oracle's
    ``peek_victim`` reads the same snapshot). For every kind but wlfu and arc
    this is the victim the step evicts; wlfu slides its window before
    evicting, and arc's pick drops the x-dependent tiebreak (|T1| == p on a
    B2 ghost hit), so in those corners the duel's candidate can differ from
    the step's victim, as in the reference and the oracle."""
    if spec.kind == "lru":
        return state["last"]
    if spec.kind == "gdsf":
        return state["score"]
    if spec.kind == "arc":
        lst = state["lst"]
        t1n = (lst == torch_cache.T1).sum(dim=-1, dtype=torch.int32)
        t2n = (lst == torch_cache.T2).sum(dim=-1, dtype=torch.int32)
        pref = torch.where((t1n > state["p"]) | (t2n == 0), torch_cache.T1, torch_cache.T2)
        return torch.where(lst == pref[:, None], state["stamp"], torch_cache._I32_MAX)
    return state["freq"]


def _dyn_chunk(topo: Topology) -> int | None:
    """Chunk length of the placed time scan: the gcd of every plfua_dyn level's
    refresh period (their global-time refreshes all land on chunk boundaries),
    or None when no level needs one."""
    periods = [lvl[0].effective_refresh for lvl in topo.levels if lvl[0].kind == "plfua_dyn"]
    return math.gcd(*periods) if periods else None


def _step_signature(spec: PolicySpec) -> tuple:
    """What ``torch_cache.step`` reads of a spec beside the capacities, which it takes per row: levels
    whose specs agree on it step together, as one batch of rows (their state tensors have the same
    shapes)."""
    return (spec.kind, spec.window, spec.effective_window if spec.kind == "tinylfu" else 0,
            spec.effective_sketch_width if spec.kind in torch_cache.SKETCH_KINDS else 0, spec.doorkeeper,
            bool(spec.capacity_bytes), spec.effective_max_victims if spec.capacity_bytes else 0)


def _row_limits(level_specs, n_samples: int, key: str) -> list:
    """A level's ``capacity`` or ``capacity_bytes`` a state row (row ``s * K + k`` is node ``k``'s,
    the spare row node 0's)."""
    values = [getattr(s, key) for s in level_specs]
    return values * n_samples + values[:1]


def _placed_prelude(topo: Topology, n_samples: int, device, *, instrument=False, sizes=None, gidx=None,
                    n_groups=0, level0_states=None, level0_caps=None, edge_group=None):
    """The placed engine's set-up: per-level specs, the plfua_dyn levels, the
    zero carry, ``inputs`` and ``step_t``, the body run at every position.

    The carry holds each level's state with its ``S * K_l`` nodes as rows
    (row ``s * K_l + k``) and one spare row at the end, the admit levels'
    placement sketches (``rows (S * K_l + 1, DEPTH, width)`` and ``seen``),
    and in a grouped run each row's per-group occupancy. Levels whose specs
    share a step signature (:func:`_step_signature`: all of a ``tree`` of one
    kind but the sketch kinds, whose widths follow the capacity) form a
    group: one tensor a state key holds the rows of all its levels, and each
    level's state is views of it, so that a position steps the group's
    consulted rows in one ``torch_cache.step``, with a capacity a row. Every
    level's ``in_cache`` rows lie in one tensor, so one gather reads a
    request's membership at every level.

    ``inputs(traces, assigns)`` turns ``(S, T)`` traces and each level's
    node assignment into position-major tensors (``x (T, S)``, each level's
    rows in the joint ``in_cache`` ``(T, L, S)``, each group's rows and ids
    ``(T, G_rows)``), read at a position as views.
    ``step_t(carry, t, inp, coins)`` takes the position, its inputs and the
    call's ``prob(p)`` coin table: it probes the miss path bottom-up on the
    pre-update membership, gathers the consulted rows of each group, steps
    them with each level's fill gate and writes them back where the request
    reached the level; a sample whose request did not reach it writes its row
    to the spare one, so an unconsulted node stays bit for bit as it was. It
    updates the carry in place and returns each level's position record:
    ``hit``, ``stored`` (x cached after the step), and under ``instrument``
    ``drop`` (occupancy lost), ``gate``, ``count`` ``(S, K_l)``, tinylfu's
    ``aging``, and grouped ``evict_g``/``count_g``. Nothing in it waits for
    the device.

    Edge sharding (one sample): ``level0_states`` ``(K_0, ...)`` and
    ``level0_caps`` ``(K_0,)`` are this process's contiguous share of the
    edges, and ``edge_group`` its group (``offset``, its first edge, and
    ``sum(tensor)``, the group's all-reduce). A request routed to another
    process's edge steps level 0's spare row here; the probe rebuilds the
    global edge-served bit with one ``edge_group.sum`` a position, and the
    upper levels run replicated. ``stored`` at level 0 is then this
    process's alone. Telemetry and byte-capacity levels are refused there."""
    if edge_group is not None:
        if instrument:
            raise NotImplementedError("telemetry is single-device (no edge mesh)")
        if any(lvl[0].capacity_bytes for lvl in topo.levels):
            raise NotImplementedError("byte-capacity placement is single-device")
        if n_samples != 1 or level0_states is None or level0_caps is None:
            raise ValueError("an edge group runs one sample from level0_states and level0_caps")
    L = topo.n_levels
    dev = resolve_device(device)
    n_s = n_samples
    specs = [lvl[0] for lvl in topo.levels]
    parsed = [placement_mod.parse(p) for p in topo.placements]
    widths = [len(lvl) for lvl in topo.levels]
    if edge_group is not None:
        widths[0] = int(level0_states["count"].shape[0])
    spare = [n_s * k for k in widths]  # a level's spare row, the last of its S * K + 1
    by_signature: dict = {}
    for l, spec in enumerate(specs):
        by_signature.setdefault(_step_signature(spec), []).append(l)
    groups = list(by_signature.values())
    # the joint layout: the groups one after the other, a group's levels one after the other
    start, row = {}, 0
    for g in groups:
        for l in g:
            start[l], row = row, row + spare[l] + 1
    in_cache = torch.zeros((row, topo.n_objects), dtype=torch.bool, device=dev)  # every level starts empty
    states, joints, caps, caps_b = [None] * L, [], [], []
    as_i32 = lambda values: torch.tensor(values, dtype=torch.int32, device=dev)
    for g in groups:
        parts: dict = {}
        for l in g:
            level = stack_level_state(topo.levels[l], n_s, dev) if l or edge_group is None else {
                k: v.unsqueeze(0) for k, v in level0_states.items()}
            for k, v in level.items():
                v = v.flatten(0, 1)
                if k == "in_cache":
                    in_cache[start[l]: start[l] + spare[l]] = v
                else:
                    parts.setdefault(k, []).append(torch.cat([v, v[:1]]))
        g0 = start[g[0]]
        joint = {"in_cache": in_cache[g0: start[g[-1]] + spare[g[-1]] + 1],
                 **{k: torch.cat(v) for k, v in parts.items()}}
        joints.append(joint)
        for l in g:
            states[l] = {k: v[start[l] - g0: start[l] - g0 + spare[l] + 1] for k, v in joint.items()}
        # per-row limits when the group's rows differ in them (else the spec's, read by the step)
        for out, key in ((caps, "capacity"), (caps_b, "capacity_bytes")):
            rows = [v for l in g for v in (_row_limits(topo.levels[l], n_s, key) if l or edge_group is None or
                                           key != "capacity" else list(level0_caps) + list(level0_caps)[:1])]
            out.append(None if len(set(rows)) == 1 or (key == "capacity_bytes" and not specs[g[0]].capacity_bytes)
                       else as_i32(rows))
    # each group's spare rows a slot (a sample of a level), group-relative
    group_spare = [torch.cat([torch.full((n_s,), start[l] - start[g[0]] + spare[l], dtype=torch.long, device=dev)
                              for l in g]) for g in groups]
    # admit levels: a count-min sketch a node. A group with an admit level keeps one sketch tensor a key
    # for all its rows, as wide as its widest, and the duel runs on all its slots at once (a level that
    # does not admit ignores its slots' gate); each admit level's sketch is a view of it
    pstates, duels = {}, {}
    for gi, g in enumerate(groups):
        params = {l: placement_mod.admit_params(topo.levels[l]) for l in g if parsed[l][0] == "admit"}
        if not params:
            continue
        n_rows = joints[gi]["count"].shape[0]
        width = max(w for w, _ in params.values())
        sk = {"rows": torch.zeros((n_rows, sketch.DEPTH, width), dtype=torch.int32, device=dev),
              "seen": torch.zeros((n_rows,), dtype=torch.int32, device=dev)}
        tables = torch.zeros((len(g), topo.n_objects, sketch.DEPTH), dtype=torch.long, device=dev)
        windows = torch.ones((len(g), n_s), dtype=torch.int32, device=dev)
        for i, l in enumerate(g):
            if l in params:
                w, windows[i] = params[l]
                tables[i] = torch.as_tensor(sketch.bucket_table(np.arange(topo.n_objects), w), device=dev)
                r0 = start[l] - start[g[0]]
                pstates[l] = {"rows": sk["rows"][r0: r0 + spare[l] + 1, :, :w],
                              "seen": sk["seen"][r0: r0 + spare[l] + 1]}
        duels[gi] = dict(sketch=sk, tables=tables, windows=windows.flatten(),
                         level=torch.arange(len(g), device=dev).repeat_interleave(n_s),
                         mask=torch.as_tensor([l in params for l in g], device=dev).repeat_interleave(n_s),
                         every=len(params) == len(g))
    carry = {"states": states, "pstates": pstates}
    if gidx is not None:
        carry["count_g"] = [torch.zeros((j["count"].shape[0], n_groups), dtype=torch.int32, device=dev)
                            for j in joints]
    every = torch.ones((n_s,), dtype=torch.bool, device=dev)
    starts = torch.as_tensor([start[l] for l in range(L)], device=dev).long()
    # a group's levels in the probe's (L, S) rows: a slice (a view) where they are consecutive
    level_rows = [slice(g[0], g[-1] + 1) if g == list(range(g[0], g[-1] + 1)) else g for g in groups]

    def inputs(traces, assigns) -> dict:
        xs = traces.t().long().contiguous()
        assigns = [a.long() for a in assigns]
        if edge_group is not None:
            # another process's edge: this one steps its spare row
            local = assigns[0] - edge_group.offset
            own0 = (local >= 0) & (local < widths[0])
            assigns[0] = torch.where(own0, local, spare[0])
        own = torch.stack([arange(n_s, dev)[:, None] * widths[l] + a for l, a in enumerate(assigns)])
        joint_rows = own.permute(2, 0, 1) + starts[:, None]  # (T, L, S)
        out = {"x": xs, "rows": joint_rows,
               "group_rows": [(joint_rows[:, g] - start[g[0]]).flatten(1) for g in groups],
               "group_x": [xs.repeat(1, len(g)) for g in groups]}
        if edge_group is not None:
            out["own0"] = own0.t().contiguous()
        return out

    def duel(gi, st, x, rows_g, cap, cap_b):
        """The admit placement over group ``gi``'s consulted slots: feed and age each slot's placement
        sketch, then fill where the node has room or x's estimate beats the pre-request victim's.
        Returns the gate and the sketch rows and ``seen`` to write back."""
        d = duels[gi]
        spec, table = specs[groups[gi][0]], d["tables"]
        idx = table[d["level"], x]
        prow = d["sketch"]["rows"].index_select(0, rows_g)
        sketch.rows_add(prow, idx)
        seen = d["sketch"]["seen"].index_select(0, rows_g) + 1
        age = seen >= d["windows"]
        prow >>= age[:, None, None].to(torch.int32)
        seen.masked_fill_(age, 0)
        victim = torch_cache._masked_argmin(_victim_key(spec, st), st["in_cache"])
        if spec.capacity_bytes:
            # byte mode: "full" = does not fit as it is (cf. tinylfu)
            size_x = 1 if sizes is None else sizes[x]
            full = st["bytes"] + size_x > (spec.capacity_bytes if cap_b is None else cap_b)
        else:
            full = st["count"] >= (spec.capacity if cap is None else cap)
        gate = ~full | (sketch.rows_estimate(prow, idx) > sketch.rows_estimate(prow, table[d["level"], victim]))
        return gate, prow, seen

    def step_t(carry, t: int, inp: dict, coins=None):
        x, rows = inp["x"], inp["rows"]
        # probe the miss path bottom-up on the pre-update membership, every level in one gather: a
        # request reaches level l iff no level below holds x
        in_c = in_cache[rows, x]
        if edge_group is not None:
            # one collective rebuilds the global edge-served bit (one process owns the edge)
            edge = edge_group.sum((in_c[0] & inp["own0"]).to(torch.int32)) > 0
            in_c = torch.cat([edge[None], in_c[1:]])
        held = in_c.cumsum(dim=0)
        act = held == in_c  # nothing below l holds x
        hits = act & in_c
        origin = held[-1] == 0
        records = [{"hit": hits[l]} for l in range(L)]
        for gi, g in enumerate(groups):
            joint, rows_g = joints[gi], inp["group_rows"][gi]
            st = {k: v.index_select(0, rows_g) for k, v in joint.items()}
            slot = lambda v, i: v[i * n_s: (i + 1) * n_s]
            x_g = inp["group_x"][gi]
            cap = None if caps[gi] is None else caps[gi][rows_g]
            cap_b = None if caps_b[gi] is None else caps_b[gi][rows_g]
            gates = []
            for l in g:
                pk, p = parsed[l]
                thr = placement_mod._threshold(p) if pk == "prob" else 0
                # served directly above level l: a hit at l + 1, or for the root an origin miss
                below = hits[l + 1] if l + 1 < L else origin
                if pk in ("lce", "admit") or (pk == "prob" and thr >= 1 << 32):
                    gates.append(None)
                elif pk == "lcd" or (pk == "prob" and thr <= 0):
                    gates.append(below)
                else:
                    gates.append(below | coins[l, t])
            if all(gate is None for gate in gates):
                fill = None
            else:
                fill = gates[0] if len(g) == 1 else torch.cat([every if gt is None else gt for gt in gates])
            if gi in duels:
                d = duels[gi]
                admit_fill, prow, seen = duel(gi, st, x_g, rows_g, cap, cap_b)
                fill = admit_fill if d["every"] else torch.where(d["mask"], admit_fill, fill)
                gates = [slot(fill, i) if parsed[l][0] == "admit" else gt for i, (l, gt) in enumerate(zip(g, gates))]
            if instrument:
                before = st["count"].clone()
                before_in = st["in_cache"].clone() if gidx is not None else None
            spec = specs[g[0]]
            torch_cache.step(spec, st, x_g, cap, fill=fill, sizes=sizes if spec.size_aware else None,
                             cap_bytes=cap_b, sync=False)
            act_g = act[level_rows[gi]].flatten()
            dst = rows_g if g == [0] else torch.where(act_g, rows_g, group_spare[gi])
            for k, v in joint.items():
                v.index_copy_(0, dst, st[k])
            if gi in duels:
                duels[gi]["sketch"]["rows"].index_copy_(0, dst, prow)
                duels[gi]["sketch"]["seen"].index_copy_(0, dst, seen)
            if not instrument:
                continue
            drop = before - st["count"]
            if gidx is not None:
                victims = torch_cache._group_counts(before_in & ~st["in_cache"], gidx, n_groups)
                count_g = carry["count_g"][gi]
                count_g.index_copy_(0, dst, torch_cache._group_counts(st["in_cache"], gidx, n_groups))
            for i, l in enumerate(g):
                rec = records[l]
                rec["drop"], rec["gate"] = slot(drop, i), gates[i]
                rec["count"] = states[l]["count"][: spare[l]].view(n_s, widths[l]).clone()
                if spec.kind == "tinylfu":
                    rec["aging"] = slot(st["seen"], i) == 0
                if gidx is not None:
                    rec["evict_g"] = slot(victims, i)
                    r0 = start[l] - start[g[0]]
                    rec["count_g"] = count_g[r0: r0 + spare[l]].view(n_s, widths[l], n_groups).clone()
        # x's membership after every level's step (at a consulted row: the one the step wrote back)
        for rec, stored in zip(records, in_cache[rows, x]):
            rec["stored"] = stored
        return records

    dyn_levels = [l for l in range(L) if specs[l].kind == "plfua_dyn"]
    return specs, dyn_levels, carry, inputs, step_t


def _placed_chunk_fn(specs, dyn_levels, step_t, *, instrument=False, gidx=None, n_groups=0):
    """The placed engine's chunk body: ``step_t`` over the chunk's positions, each level's records
    stacked to ``(G, ...)``, then each plfua_dyn level's hot-set refresh on all its rows where its
    ``fire`` flag (a host bool) is set, with its churn ``(S * K,)`` (``churn_g`` ``(S * K, n_groups)``)
    under ``instrument``. The chunk's positions are ``t0 ..`` ``t0 + G - 1``, ``inp`` their inputs
    (position-major, see :func:`_placed_prelude`)."""

    def chunk_fn(carry, t0: int, inp: dict, fire_c, coins=None):
        n = inp["x"].shape[0]
        at = lambda v, i: [u[i] for u in v] if isinstance(v, list) else v[i]
        steps = [step_t(carry, t0 + i, {k: at(v, i) for k, v in inp.items()}, coins) for i in range(n)]
        # a level's record of each key, (G, ...) over the chunk (None stays None: an lce level's gate)
        out = [{k: None if v is None else torch.stack([s[l][k] for s in steps]) for k, v in steps[0][l].items()}
               for l in range(len(specs))]
        for j, l in enumerate(dyn_levels):
            state = carry["states"][l]
            old_hot = state["hot"].clone() if instrument else None
            if fire_c[j]:
                torch_cache.refresh_hot(specs[l], {"hot": state["hot"], "sketch": state["sketch"]})
            if instrument:
                r_n = state["hot"].shape[0] - 1
                diff = old_hot[:r_n] != state["hot"][:r_n]
                out[l]["churn"] = diff.sum(dim=1, dtype=torch.int32)
                if gidx is not None:
                    out[l]["churn_g"] = torch_cache._group_counts(diff, gidx, n_groups)
        return carry, out

    return chunk_fn


def _placed_untile(chunks: list, n_levels: int):
    """Join the chunks' records along time: each level's ``(T, ...)`` series, and plfua_dyn's
    per-chunk churn ``(n_chunks, ...)``."""
    out = []
    for l in range(n_levels):
        rec = {}
        for k, v in chunks[0][l].items():
            parts = [c[l][k] for c in chunks]
            if v is None:
                rec[k] = None
            elif k in ("churn", "churn_g"):
                rec[k] = torch.stack(parts)  # one a chunk
            else:
                rec[k] = torch.cat(parts)
        out.append(rec)
    return out


def _fire_schedule(specs, dyn_levels, trace_len: int, chunk_len: int, t0: int = 0) -> np.ndarray:
    """``(n_chunks, n_dyn)`` bool: each plfua_dyn level's ``torch_cache.refresh_fires`` over the
    chunks of ``trace_len`` positions from global position ``t0`` (a stream chunk's start)."""
    n_chunks = -(-trace_len // chunk_len)
    fires = [torch_cache.refresh_fires(specs[l].effective_refresh, chunk_len, trace_len, t0) for l in dyn_levels]
    return np.array(fires, bool).reshape(len(dyn_levels), n_chunks).T


def _placed_run(topo: Topology, traces, assigns, *, instrument=False, sizes=None, gidx=None, n_groups=0,
                level0_states=None, level0_caps=None, edge_group=None):
    """The time-major scan over ``(S, T)`` traces, ``assigns`` one ``(S, T)`` node assignment per
    level: chunks of the gcd of the plfua_dyn levels' periods (or the whole trace), the last one
    cut short at ``T``. Returns ``(carry, records, fire, chunk_len)``: the final carry, each
    level's records (see :func:`_placed_prelude`; hits and ids as ``(T, S)``) and the refresh
    schedule. ``level0_states``/``level0_caps``/``edge_group`` shard the edges (see
    :func:`_placed_prelude`)."""
    s_n, t_n = traces.shape
    dev = traces.device
    specs, dyn_levels, carry, inputs, step_t = _placed_prelude(
        topo, s_n, dev, instrument=instrument, sizes=sizes, gidx=gidx, n_groups=n_groups,
        level0_states=level0_states, level0_caps=level0_caps, edge_group=edge_group)
    chunk_len = _dyn_chunk(topo) or t_n
    fire = _fire_schedule(specs, dyn_levels, t_n, chunk_len)
    coins = placement_mod.coin_table(topo.placements, t_n, dev)
    chunk_fn = _placed_chunk_fn(specs, dyn_levels, step_t, instrument=instrument, gidx=gidx, n_groups=n_groups)
    inp = inputs(traces, assigns)
    chunks = []
    for c, t0 in enumerate(range(0, t_n, chunk_len)):
        t1 = min(t0 + chunk_len, t_n)
        sub = {k: [u[t0:t1] for u in v] if isinstance(v, list) else v[t0:t1] for k, v in inp.items()}
        carry, out = chunk_fn(carry, t0, sub, fire[c], coins)
        chunks.append(out)
    return carry, _placed_untile(chunks, topo.n_levels), fire, chunk_len


def assemble_placed(topo: Topology, traces, assigns, carry, records, *, telemetry=None, fire=None,
                    chunk_len=None, sizes=None, groups_t=None) -> dict:
    """Fold a placed run into the ``simulate_fleet`` result. A node is active at a position iff
    the request is routed to it and no level below served it, the level-major engine's masks;
    the counters, and the consulted-node events of a telemetry run, are scattered to nodes
    through them: fills are the consulted misses whose object the step cached, evictions
    ``fills - count``, and ``admitted_requests`` follows :func:`tier_counters`' conventions."""
    s_n, t_n = traces.shape
    dev = traces.device
    grouped = telemetry is not None and telemetry.n_groups > 0
    sz_t = None if sizes is None else sizes[traces.long()]
    demand = torch.ones((s_n, t_n), dtype=torch.bool, device=dev)
    tiers, node_hits, hit_lv, states_out, series, pressure = [], [], [], [], [], []
    dyn_levels = [l for l, lvl in enumerate(topo.levels) if lvl[0].kind == "plfua_dyn"]
    for l, specs in enumerate(topo.levels):
        spec, k_n = specs[0], len(specs)
        rec = {k: None if v is None or k in ("churn", "churn_g", "count", "count_g") else v.movedim(0, 1)
               for k, v in records[l].items()}
        hit = rec["hit"]
        state = {k: v[: s_n * k_n].view((s_n, k_n) + v.shape[1:]) for k, v in carry["states"][l].items()}
        active = (assigns[l].unsqueeze(1) == arange(k_n, dev)[:, None]) & demand.unsqueeze(1)
        nh = active & hit.unsqueeze(1)
        insert = demand & ~hit & rec["stored"]
        total = lambda v: v.sum(dim=-1, dtype=torch.int32)
        fills = total(active & insert.unsqueeze(1))
        if spec.kind == "plfua":
            # plfua's hot set never changes: the final mask is the one each step read
            hot = state["hot"]
            at_x = torch.gather(hot, -1, traces.long().unsqueeze(1).expand(hot.shape[:-1] + (t_n,)))
            admitted = total(active & at_x)
        elif spec.kind in torch_cache.SKETCH_KINDS:
            admitted = total(nh) + fills
        else:
            admitted = total(active)
        count = state["count"]
        tier = {"requests": total(active), "hits": total(nh), "admitted_requests": admitted, "inserts": fills,
                "evictions": fills - count, "count": count}
        if sz_t is not None:
            sz = sz_t.unsqueeze(1)
            tier["req_bytes"] = total(active * sz)
            tier["hit_bytes"] = total(nh * sz)
        if spec.capacity_bytes:
            tier["bytes"] = state["bytes"]
        tiers.append(tier)
        node_hits.append(nh)
        hit_lv.append(hit)
        states_out.append(state)
        if telemetry is not None:
            per_node = lambda v: active & v.unsqueeze(1)
            consulted_miss = demand & ~hit
            offers = consulted_miss if rec["gate"] is None else consulted_miss & rec["gate"]
            events = {"fill": per_node(insert), "offer": per_node(offers),
                      "aging": None if "aging" not in rec else per_node(demand & rec["aging"])}
            fired = churn = churn_g = None
            if l in dyn_levels:
                j = dyn_levels.index(l)
                fired = torch.as_tensor(fire[:, j], device=dev).expand(s_n, k_n, -1)
                churn = records[l]["churn"].t().reshape(s_n, k_n, -1)
                if grouped:
                    churn_g = records[l]["churn_g"].movedim(0, 1).reshape(s_n, k_n, -1, telemetry.n_groups)
            common = dict(hits=nh, active=active, fills=events["fill"], offers=events["offer"],
                          aging=events["aging"], fired=fired,
                          hit_bytes=None if sz_t is None else nh * sz_t.unsqueeze(1),
                          miss_bytes=None if sz_t is None else (active & ~nh) * sz_t.unsqueeze(1),
                          chunk_len=chunk_len)
            if grouped:
                evict_g = active.unsqueeze(-1) * torch.where(demand.unsqueeze(-1), rec["evict_g"], 0).unsqueeze(1)
                series.append(telemetry_spec.grouped_series_from_run(
                    telemetry.window, t_n, telemetry.n_groups, groups_t.unsqueeze(1), evictions_g=evict_g,
                    occupancy_g=records[l]["count_g"].permute(1, 2, 0, 3), churn_g=churn_g, **common))
                pressure.append(telemetry_spec.windowed_pressure(telemetry.window, groups_t.unsqueeze(1), evict_g))
            else:
                evict = torch.where(demand, rec["drop"], 0) + insert
                series.append(telemetry_spec.series_from_run(
                    telemetry.window, t_n, evictions=active * evict.unsqueeze(1),
                    occupancy=records[l]["count"].permute(1, 2, 0), churn=churn, **common))
        demand = demand & ~hit
    out = {
        "hit": tuple(hit_lv),
        "node_hit": tuple(node_hits),
        "tiers": tuple(tiers),
        "states": tuple(states_out),
        "origin_miss": demand,
        # the admit levels' placement sketches, level -> rows (S, K, DEPTH, width) and seen (S, K)
        "placement_states": {
            l: {k: v[: s_n * len(topo.levels[l])].reshape((s_n, len(topo.levels[l])) + v.shape[1:])
                for k, v in ps.items()}
            for l, ps in carry["pstates"].items()
        },
    }
    if telemetry is not None:
        out["telemetry"] = tuple(series)
        if grouped:
            out["telemetry_pressure"] = tuple(pressure)
    return out


def _simulate_placed_impl(topo: Topology, traces, assignments, telemetry=None, sizes=None, groups=None) -> dict:
    """The placed engine on checked ``(S, T)`` inputs (see :func:`_check_inputs`)."""
    gidx, groups_t = torch_cache.group_scatter_arrays(telemetry, groups, traces)
    assigns = level_assignments(topo, traces, assignments)
    n_groups = telemetry.n_groups if telemetry is not None else 0
    carry, records, fire, chunk_len = _placed_run(topo, traces, assigns, instrument=telemetry is not None,
                                                  sizes=sizes, gidx=gidx, n_groups=n_groups)
    return assemble_placed(topo, traces, assigns, carry, records, telemetry=telemetry, fire=fire,
                           chunk_len=chunk_len, sizes=sizes, groups_t=groups_t)


def _map(fn, tree):
    """Apply ``fn`` to every tensor of a result's nested tuples and dicts."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def simulate_fleet(topo: Topology, trace, assignment, telemetry=None, sizes=None, groups=None, *, device=None) -> dict:
    """Run one ``(T,)`` trace, routed by ``assignment`` (``(T,)`` edge ids,
    e.g. ``topo.assignment(trace)``), through an N-tier topology on
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
    tenant's requests. A topology with a non-lce placement runs the
    time-major engine, whose dict also holds ``placement_states``: each admit
    level's placement sketch (``rows (K_l, DEPTH, width)``, ``seen (K_l,)``)
    by level index."""
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
