"""The streaming fleet engine: an unbounded request stream as fixed-shape chunks.

The bounded engines of :mod:`repro_torch.fleet.sim` take one trace per call.
Production load is a stream, and the paper's headline quantity, management
time and energy a request, means something only at a sustained rate. This
module runs the stream as ``chunk_len``-shaped chunks with three invariants:

* **An owned carry.** :class:`FleetStream` allocates the fleet's state (cache
  directories, sketch rows, ARC lists, placement sketches, counter
  accumulators) once, and every push writes the new state into the same
  tensors: the engines step them in place, and where one returns new tensors
  they are copied in. In steady state a push allocates the chunk's tensors,
  not the fleet state's. User code never touches the carry.

* **Bit for bit the bounded engines.** K pushed chunks reproduce
  ``simulate_fleet`` (or the flat ``torch_cache.simulate``) on the
  concatenated trace exactly: hit series, final states, tier counters,
  grouped telemetry series and eviction pressure. plfua_dyn's global-time
  hot-set refresh is the hard part: a chunk runs in sub-chunks of
  gcd(refresh, chunk_len) and refreshes after one whose global end is a whole
  multiple of the period (``torch_cache.refresh_fires``, through the
  level-major scan's ``sim.refresh_chunks`` and the placed engine's
  ``_fire_schedule``), which is the bounded schedule for any chunk length. Telemetry stitches because the window
  divides the chunk (the config enforces it), so every chunk emits whole
  windows.

* **Double-buffered synthesis.** :func:`stream_fleet` generates chunk ``c +
  1`` (``workloads.device.gen_stream_chunk``) on a side CUDA stream while
  chunk ``c`` is pushed on the main one, which waits on the side stream's
  event before it reads the chunk.

The **fast path** (``StreamConfig(fast=True)``, one flat cache) replaces the
dense ``(n_objects,)`` step with a compact working set: each chunk selects
the ``P = min(2 * chunk_len, capacity + chunk_len)`` smallest ``(eviction
key, id)`` residents from a roster, unions them with the chunk's ids, and
runs the unchanged ``torch_cache.step`` on those ``P + chunk_len`` lanes,
gathering each lane's fields and its sketch and bloom rows and scattering
them back afterwards. It rests on the candidate-prefix bound: one step
invalidates at most two prefix entries (the touched object and the victim;
every other resident's eviction key is constant within a chunk for the
FAST_KINDS), so a ``2 * chunk_len`` prefix always holds the true victim, ties
included. The lanes are id-sorted, so the masked argmin's lowest-id
tie-break is the dense engine's. The per-object fields of the fast carry
keep one spare row at index ``n_objects``, where the sentinel lanes (id
``n_objects``) read and write; nothing in a chunk waits for the device.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.core import energy, torch_cache
from repro_torch.core.torch_cache import PolicySpec
from repro_torch.fleet import placement as placement_mod
from repro_torch.fleet import sim as sim_mod
from repro_torch.fleet.topology import Topology
from repro_torch.telemetry import spec as telemetry_spec
from repro_torch.telemetry.spec import TelemetrySpec
from repro_torch.workloads import device as device_mod

__all__ = [
    "FAST_KINDS",
    "FleetStream",
    "StreamConfig",
    "StreamStats",
    "stream_fleet",
]

#: kinds whose eviction key is per-object and touch-local (untouched cached
#: objects keep their key within a chunk), which the fast path's
#: candidate-prefix bound needs. wlfu is out (the window slide retires other
#: objects' counts every step), arc is out (REPLACE moves whole-list LRU
#: positions), byte mode is out (one insert can evict many victims).
FAST_KINDS = ("lru", "lfu", "plfu", "plfua", "plfua_dyn", "gdsf", "tinylfu")

#: routers usable above the edge in a stream: a pure function of the request
#: id ("hash") or of the lower level's assignment ("tree"). "sticky" and
#: "round_robin" key on the trace position, which a chunked stream resets
#: every push: they would silently diverge from the bounded engine.
_STREAM_ROUTERS = ("tree", "hash")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static configuration of a streaming run.

    ``chunk_len`` is the fixed shape of every pushed chunk. With telemetry,
    the window must divide it so chunks emit whole windows (stitching is
    then concatenation). ``fast=True`` selects the compact working-set
    engine: one flat cache (depth 1, one node), FAST_KINDS, object-count
    capacity, no telemetry; plfua_dyn also needs its refresh period to be a
    multiple of ``chunk_len`` so its refreshes land on chunk boundaries."""

    topo: Topology
    chunk_len: int
    telemetry: TelemetrySpec | None = None
    fast: bool = False

    def __post_init__(self):
        if self.chunk_len < 1:
            raise ValueError(f"chunk_len must be >= 1, got {self.chunk_len}")
        for mode in self.topo.routers[1:]:
            if mode not in _STREAM_ROUTERS:
                raise ValueError(
                    f"streaming upper levels need a position-independent router {_STREAM_ROUTERS}, got {mode!r} "
                    f"(its assignment depends on the trace position, which a chunked stream resets every push)")
        if self.telemetry is not None and self.chunk_len % self.telemetry.window:
            raise ValueError(
                f"telemetry window ({self.telemetry.window}) must divide chunk_len ({self.chunk_len}) so every "
                f"chunk emits whole windows (series stitch by concatenation)")
        if self.fast:
            if self.topo.n_levels != 1 or len(self.topo.levels[0]) != 1:
                raise ValueError("fast=True needs a depth-1, single-node topology")
            spec = self.topo.levels[0][0]
            if spec.kind not in FAST_KINDS:
                raise ValueError(f"fast=True supports kinds {FAST_KINDS}, got {spec.kind!r}")
            if spec.capacity_bytes:
                raise ValueError("fast=True is object-count only (no byte mode)")
            if self.telemetry is not None:
                raise ValueError("fast=True does not support telemetry")
            if spec.kind == "plfua_dyn" and spec.effective_refresh % self.chunk_len:
                raise ValueError(
                    f"fast plfua_dyn needs refresh % chunk_len == 0 (refresh={spec.effective_refresh}, "
                    f"chunk_len={self.chunk_len}) so hot-set refreshes land on chunk boundaries")


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """Rollup of one streaming run.

    ``tiers`` follows the bounded engines' per-level counter dicts
    (``sim.tier_counters`` / ``assemble_placed``) as ``(K_l,)`` int32
    tensors; the fast path reports the reduced dict its carry can derive
    (requests/hits/count[, inserts, evictions]). ``telemetry``/
    ``telemetry_pressure`` are the stitched per-level series, shaped like
    ``simulate_fleet``'s on the concatenated trace."""

    requests: int
    chunks: int
    chunk_len: int
    hits: int
    origin_misses: int
    tiers: tuple
    elapsed_s: float | None = None
    telemetry: tuple | None = None
    telemetry_pressure: tuple | None = None

    @property
    def total_chr(self) -> float:
        """Fleet-level hit ratio: served by any tier / total requests."""
        return self.hits / max(1, self.requests)

    @property
    def req_per_s(self) -> float | None:
        """Sustained throughput over the measured wall-clock window."""
        if not self.elapsed_s:
            return None
        return self.requests / self.elapsed_s

    @property
    def j_per_step(self) -> float | None:
        """Management energy a request: core.energy's single-core CPU model
        over the sustained wall clock."""
        if not self.elapsed_s:
            return None
        return energy.mgmt_energy_j(self.elapsed_s) / max(1, self.requests)


def _sub_len(spec: PolicySpec, chunk_len: int) -> int | None:
    """The sub-chunk plfua_dyn's fired/churn events are emitted over inside
    one stream chunk, or None for kinds without such events."""
    return torch_cache.stream_sub_len(spec, chunk_len) if spec.kind == "plfua_dyn" else None


def _acc_keys(spec: PolicySpec, sized: bool) -> tuple[str, ...]:
    """Counter accumulators a level needs beyond requests/hits, mirroring
    ``sim.tier_counters``: kinds whose insert count is not carried in state
    sum it from each chunk's misses; plfua also sums its hot-gated requests;
    sized runs sum byte traffic."""
    keys = ["requests", "hits"]
    if spec.kind == "plfua":
        keys.append("admitted")
        if not spec.capacity_bytes:
            keys.append("inserts")
    elif spec.kind not in torch_cache.SKETCH_KINDS and not spec.capacity_bytes:
        keys.append("inserts")
    if sized:
        keys += ["req_bytes", "hit_bytes"]
    return tuple(keys)


def _accumulate_level(spec: PolicySpec, acc: dict, active, hits, traces, state, sz_t) -> None:
    """Add one chunk's ``(1, K, G)`` activity and hits to a level's ``(1, K)``
    accumulators, in place."""
    total = lambda v: v.sum(dim=-1, dtype=torch.int32)
    acc["requests"] += total(active)
    acc["hits"] += total(hits)
    miss = active & ~hits
    if spec.kind == "plfua":
        # plfua's hot set never changes: the chunk's final mask is the one each step read
        hot = state["hot"]
        admitted = torch.gather(hot, -1, traces.long().unsqueeze(1).expand(hot.shape[:-1] + traces.shape[-1:]))
        if "inserts" in acc:
            acc["inserts"] += total(miss & admitted)
        acc["admitted"] += total(active & admitted)
    elif "inserts" in acc:
        acc["inserts"] += total(miss)
    if sz_t is not None:
        sz = sz_t.unsqueeze(1)
        acc["req_bytes"] += total(active * sz)
        acc["hit_bytes"] += total(hits * sz)


def _tier_from_acc(spec: PolicySpec, acc: dict, state: dict) -> dict:
    """One level's final counter dict from its accumulators and final state:
    the streaming closure of ``sim.tier_counters``."""
    if spec.capacity_bytes or spec.kind in torch_cache.SKETCH_KINDS:
        inserts = state["inserts"]
    else:
        inserts = acc["inserts"]
    if spec.kind == "plfua":
        admitted = acc["admitted"]
    elif spec.kind in torch_cache.SKETCH_KINDS:
        admitted = acc["hits"] + inserts
    else:
        admitted = acc["requests"]
    count = state["count"]
    tier = {"requests": acc["requests"], "hits": acc["hits"], "admitted_requests": admitted, "inserts": inserts,
            "evictions": inserts - count, "count": count}
    if "req_bytes" in acc:
        tier["req_bytes"] = acc["req_bytes"]
        tier["hit_bytes"] = acc["hit_bytes"]
    if spec.capacity_bytes:
        tier["bytes"] = state["bytes"]
    return tier


class _LevelMajor:
    """Level-major chunks: each level runs through ``sim.run_level`` from the
    carried states at the chunk's global start (one sample; states ``(1, K,
    ...)``)."""

    def __init__(self, cfg: StreamConfig, sizes, groups, dev):
        self.cfg, self.sizes, self.groups = cfg, sizes, groups
        topo = cfg.topo
        self.states = [sim_mod.stack_level_state(lvl, 1, dev) for lvl in topo.levels]
        zero = lambda lvl: torch.zeros((1, len(lvl)), dtype=torch.int32, device=dev)
        self.acc = [{k: zero(lvl) for k in _acc_keys(lvl[0], sizes is not None)} for lvl in topo.levels]
        self.origin = torch.zeros((), dtype=torch.int32, device=dev)

    def push(self, traces, assignments, t0: int) -> dict:
        cfg, sizes = self.cfg, self.sizes
        topo, telemetry, g_n = cfg.topo, cfg.telemetry, cfg.chunk_len
        instrument = telemetry is not None
        gidx, groups_t = torch_cache.group_scatter_arrays(telemetry, self.groups, traces)
        n_groups = telemetry.n_groups if instrument else 0
        assigns = sim_mod.level_assignments(topo, traces, assignments)
        sz_t = None if sizes is None else sizes[traces.long()]
        demand = torch.ones_like(traces, dtype=torch.bool)
        hit_lv, node_hit, series, pressure = [], [], [], []
        for l, specs in enumerate(topo.levels):
            s0 = specs[0]
            out = sim_mod.run_level(specs, traces, assigns[l], demand, instrument=instrument, sizes=sizes, gidx=gidx,
                                    n_groups=n_groups, state=self.states[l], t0=t0)
            states, hits, active = out[:3]
            if instrument:
                events = out[3]
                if sz_t is not None:
                    sim_mod._level_byte_events(events, hits, active, sz_t)
                series.append(sim_mod.level_series(s0, telemetry, g_n, hits, active, events, groups_t,
                                                   chunk_len=_sub_len(s0, g_n))[0])
                if gidx is not None:
                    pressure.append(telemetry_spec.windowed_pressure(telemetry.window, groups_t.unsqueeze(-2),
                                                                     events["evict_g"])[0])
            _accumulate_level(s0, self.acc[l], active, hits, traces, states, sz_t)
            for k, v in states.items():
                self.states[l][k].copy_(v)
            node_hit.append(hits[0])
            hit = hits.any(dim=1)
            hit_lv.append(hit[0])
            demand = demand & ~hit
        self.origin += demand.sum(dtype=torch.int32)
        return _chunk_out(hit_lv, node_hit, demand[0], series, pressure, instrument, gidx is not None)

    def states_out(self) -> tuple:
        return tuple({k: v[0] for k, v in st.items()} for st in self.states)

    def tiers(self) -> tuple:
        return tuple({k: v[0] for k, v in _tier_from_acc(lvl[0], acc, st).items()}
                     for lvl, acc, st in zip(self.cfg.topo.levels, self.acc, self.states))


def _chunk_out(hit_lv, node_hit, origin_miss, series, pressure, instrument: bool, grouped: bool) -> dict:
    out = {"hit": tuple(hit_lv), "node_hit": tuple(node_hit), "origin_miss": origin_miss}
    if instrument:
        out["telemetry"] = tuple(series)
        if grouped:
            out["telemetry_pressure"] = tuple(pressure)
    return out


class _Placed:
    """Placed chunks: the bounded placed engine's prelude, ``step_t`` and
    chunk body, run over sub-chunks of gcd(gcd of the plfua_dyn periods,
    chunk_len) with the host's fire flags at global positions, the chunk's
    ``prob(p)`` coins drawn at its global positions, and each chunk folded
    (counters, per-node telemetry) by ``sim.assemble_placed``."""

    _SUMMED = ("requests", "hits", "admitted_requests", "inserts", "req_bytes", "hit_bytes")

    def __init__(self, cfg: StreamConfig, sizes, groups, dev):
        self.cfg, self.sizes, self.groups, self.dev = cfg, sizes, groups, dev
        topo, telemetry = cfg.topo, cfg.telemetry
        self.instrument = telemetry is not None
        self.grouped = self.instrument and telemetry.n_groups > 0
        self.gidx = torch_cache._group_index(groups, telemetry.n_groups) if self.grouped else None
        self.specs, self.dyn_levels, self.carry, self.inputs, step_t = sim_mod._placed_prelude(
            topo, 1, dev, instrument=self.instrument, sizes=sizes, gidx=self.gidx,
            n_groups=telemetry.n_groups if self.grouped else 0)
        gdyn = sim_mod._dyn_chunk(topo)
        self.sub = math.gcd(gdyn, cfg.chunk_len) if gdyn else cfg.chunk_len
        self.chunk_fn = sim_mod._placed_chunk_fn(self.specs, self.dyn_levels, step_t, instrument=self.instrument,
                                                 gidx=self.gidx, n_groups=telemetry.n_groups if self.grouped else 0)
        self.acc = None
        self.origin = torch.zeros((), dtype=torch.int32, device=dev)

    def push(self, traces, assignments, t0: int) -> dict:
        cfg, sub = self.cfg, self.sub
        topo, g_n = cfg.topo, cfg.chunk_len
        n_sub = g_n // sub
        assigns = sim_mod.level_assignments(topo, traces, assignments)
        inp = self.inputs(traces, assigns)
        coins = placement_mod.coin_table(topo.placements, g_n, self.dev, start=t0)
        fire = sim_mod._fire_schedule(self.specs, self.dyn_levels, g_n, sub, t0)
        chunks = []
        for i in range(n_sub):
            a, b = i * sub, (i + 1) * sub
            part = {k: [u[a:b] for u in v] if isinstance(v, list) else v[a:b] for k, v in inp.items()}
            _, out = self.chunk_fn(self.carry, a, part, fire[i], coins)
            chunks.append(out)
        records = sim_mod._placed_untile(chunks, topo.n_levels)
        groups_t = None if not self.grouped else self.groups[traces.long()]
        res = sim_mod.assemble_placed(topo, traces, assigns, self.carry, records, telemetry=cfg.telemetry,
                                      fire=fire, chunk_len=sub, sizes=self.sizes, groups_t=groups_t)
        if self.acc is None:
            self.acc = [{k: torch.zeros_like(v) for k, v in tier.items() if k in self._SUMMED}
                        for tier in res["tiers"]]
        for acc, tier in zip(self.acc, res["tiers"]):
            for k, v in acc.items():
                v += tier[k]
        self.origin += res["origin_miss"].sum(dtype=torch.int32)
        series = [s[0] for s in res.get("telemetry", ())]
        pressure = [p[0] for p in res.get("telemetry_pressure", ())]
        return _chunk_out([h[0] for h in res["hit"]], [h[0] for h in res["node_hit"]], res["origin_miss"][0],
                          series, pressure, self.instrument, self.grouped)

    def states_out(self) -> tuple:
        return tuple({k: v[:len(lvl)] for k, v in st.items()}
                     for lvl, st in zip(self.cfg.topo.levels, self.carry["states"]))

    def tiers(self) -> tuple:
        out = []
        for lvl, acc, st in zip(self.cfg.topo.levels, self.acc, self.states_out()):
            tier = {k: v[0] for k, v in acc.items() if k in ("requests", "hits", "admitted_requests", "inserts")}
            count = st["count"]
            tier.update(evictions=tier["inserts"] - count, count=count)
            for k in ("req_bytes", "hit_bytes"):
                if k in acc:
                    tier[k] = acc[k][0]
            if lvl[0].capacity_bytes:
                tier["bytes"] = st["bytes"]
            out.append(tier)
        return tuple(out)


#: per-object fields of a FAST_KINDS state gathered into the compact lanes
#: (the rest, count/t/L/sketch/seen/inserts/bloom, is a scalar or a small
#: table that the lanes' steps update in place)
_PER_OBJECT_FIELDS = ("in_cache", "last", "freq", "score", "hot")


class _Fast:
    """The compact working-set engine of one flat cache (see the module
    docstring). The state is batched with one sample, and each per-object
    field has a spare row at index N for the sentinel lanes."""

    def __init__(self, cfg: StreamConfig, sizes, dev):
        spec = cfg.topo.levels[0][0]
        self.spec, self.dev = spec, dev
        n, g_n = spec.n_objects, cfg.chunk_len
        self.n, self.g_n = n, g_n
        self.r_n = spec.capacity + g_n  # roster slots: residents never exceed cap (+G slack)
        self.p_n = min(2 * g_n, self.r_n)  # candidate prefix (>= 2 invalidations a step)
        self.cspec = dataclasses.replace(spec, n_objects=self.p_n + g_n)
        spare = lambda v: torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
        self.state = {k: spare(v) if k in _PER_OBJECT_FIELDS else v
                      for k, v in torch_cache.init_state(spec, 1, device=dev).items()}
        tables = torch_cache._tables(spec, dev) if spec.kind in torch_cache.SKETCH_KINDS else (None, None)
        pad = lambda t: None if t is None else torch.cat([t, t[:1]])
        self.table, self.bloom = pad(tables[0]), pad(tables[1])
        self.sizes = None if sizes is None else pad(sizes)
        self.roster = torch.full((self.r_n,), n, dtype=torch.long, device=dev)
        self.hits = torch.zeros((), dtype=torch.int32, device=dev)

    def push(self, trace, t0: int) -> dict:
        spec, state, n, g_n = self.spec, self.state, self.n, self.g_n
        xs = trace.long()
        roster = self.roster
        # candidates: the P smallest (eviction key, id) residents, sentinel-padded with N; one int64
        # key (key << 32 | id) sorts them lexicographically (keys are int32, ids below 2**31)
        key = sim_mod._victim_key(spec, state)[0]
        rkey = torch.where(roster < n, key[roster], torch_cache._I32_MAX).long()
        cand = torch.sort((rkey << 32) | roster).values[: self.p_n] & 0xFFFFFFFF
        # lanes: candidates and the chunk's ids, id-sorted, duplicates turned into sentinels
        ids = torch.sort(torch.cat([cand, xs])).values
        dup = torch.cat([ids.new_zeros(1, dtype=torch.bool), ids[1:] == ids[:-1]])
        ids = torch.sort(torch.where(dup, n, ids)).values
        lanes = {k: v[:, ids] if k in _PER_OBJECT_FIELDS else v for k, v in state.items()}
        table = None if self.table is None else self.table[ids]
        bloom = None if self.bloom is None else self.bloom[ids]
        sizes = None if self.sizes is None else self.sizes[ids]
        lx = torch.searchsorted(ids, xs)
        hits = torch.empty(g_n, dtype=torch.bool, device=self.dev)
        for i in range(g_n):
            _, hit = torch_cache.step(self.cspec, lanes, lx[i:i + 1], sizes=sizes, table=table, bloom_tab=bloom)
            hits[i:i + 1] = hit
        # scatter back: the sentinel lanes all write the spare row's unchanged values
        for k in _PER_OBJECT_FIELDS:
            if k in state:
                state[k][:, ids] = lanes[k]
        if spec.kind == "plfua_dyn" and torch_cache.refresh_fires(spec.effective_refresh, g_n, g_n, t0)[0]:
            # the refresh period is a whole number of chunks: its only boundary is the chunk's end
            torch_cache.refresh_hot(spec, {"hot": state["hot"][:, :n], "sketch": state["sketch"]})
        # roster: the residents are among the old roster and the chunk's ids
        r2 = torch.sort(torch.cat([roster, xs])).values
        dup2 = torch.cat([r2.new_zeros(1, dtype=torch.bool), r2[1:] == r2[:-1]])
        keep = ~dup2 & (r2 < n) & state["in_cache"][0, r2]
        roster.copy_(torch.sort(torch.where(keep, r2, n)).values[: self.r_n])
        self.hits += hits.sum(dtype=torch.int32)
        return {"hit": (hits,), "node_hit": (hits[None],), "origin_miss": ~hits}

    def states_out(self) -> tuple:
        n = self.n
        return ({k: v[0, :n] if k in _PER_OBJECT_FIELDS else v[0] for k, v in self.state.items()},)


class FleetStream:
    """Push-driven streaming run of one topology (see the module docstring).

    Construct once a stream; :meth:`push` takes fixed-shape chunks and
    returns each chunk's results (hit series, per-node hits, origin misses,
    and with telemetry the chunk's series, as tensors on the device);
    :meth:`stats` rolls the stream up into a :class:`StreamStats`. The
    carry lives on ``device`` (the card unless ``"cpu"``) and is written in
    place by every push."""

    def __init__(self, cfg: StreamConfig, *, sizes=None, groups=None, device=None):
        self.cfg = cfg
        dev = self.device = resolve_device(device)
        n = cfg.topo.n_objects
        if sizes is not None:
            sizes = torch.as_tensor(sizes, device=dev).to(torch.int32)
            if tuple(sizes.shape) != (n,):
                raise ValueError(f"sizes must have shape ({n},), got {tuple(sizes.shape)}")
        telemetry = cfg.telemetry
        if telemetry is not None and telemetry.n_groups:
            if groups is None:
                raise ValueError("telemetry.n_groups > 0 requires a groups catalogue")
            groups = torch.as_tensor(groups, device=dev).to(torch.int32)
        else:
            groups = None
        if cfg.fast:
            self._engine = _Fast(cfg, sizes, dev)
        elif cfg.topo.has_placement:
            self._engine = _Placed(cfg, sizes, groups, dev)
        else:
            self._engine = _LevelMajor(cfg, sizes, groups, dev)
        self.chunks = 0
        self.t0 = 0  # the next chunk's global start position
        self._series = [[] for _ in cfg.topo.levels] if telemetry is not None else None
        self._pressure = [[] for _ in cfg.topo.levels] if groups is not None else None

    def push(self, trace, assignment=None) -> dict:
        """Run one chunk. ``trace`` must be ``(chunk_len,)``; ``assignment``
        is each request's edge node (same shape); omit it to route on the
        device, which needs a single edge or the id-pure ``"hash"`` edge
        router (position-keyed routers cannot be chunked)."""
        cfg, dev = self.cfg, self.device
        g_n = cfg.chunk_len
        trace = torch.as_tensor(trace, device=dev)
        if tuple(trace.shape) != (g_n,):
            raise ValueError(f"expected chunk of shape ({g_n},), got {tuple(trace.shape)}")
        trace = trace.to(torch.int32)
        if cfg.fast:
            out = self._engine.push(trace, self.t0)
        else:
            if assignment is None:
                if cfg.topo.n_edges == 1:
                    assignment = torch.zeros((g_n,), dtype=torch.int32, device=dev)
                elif cfg.topo.router == "hash":
                    from repro_torch.cdn import router as router_mod  # cdn imports the topology

                    assignment = router_mod.route_device(trace, cfg.topo.n_edges, cfg.topo.router,
                                                         session_len=cfg.topo.session_len)
                else:
                    raise ValueError(f"edge router {cfg.topo.router!r} keys on the trace position; pass an "
                                     f"explicit per-chunk assignment")
            assignment = torch.as_tensor(assignment, device=dev).to(torch.int32)
            out = self._engine.push(trace[None], assignment[None], self.t0)
            if self._series is not None:
                for l, s in enumerate(out["telemetry"]):
                    self._series[l].append(s)
            if self._pressure is not None:
                for l, p in enumerate(out["telemetry_pressure"]):
                    self._pressure[l].append(p)
        self.chunks += 1
        self.t0 += g_n
        return out

    def block(self) -> "FleetStream":
        """Wait for every queued chunk to finish (throughput timing)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def states(self) -> tuple:
        """Per-level stacked final policy states (fast path: the one flat
        state), laid out like ``simulate_fleet``'s ``states``."""
        return self._engine.states_out()

    def stats(self, elapsed_s: float | None = None) -> StreamStats:
        """Roll the stream up. The counters follow the bounded engines'
        (``tier_counters`` / ``assemble_placed``); the telemetry series are
        the chunks' window series concatenated (bit for bit the bounded
        series over the concatenated trace)."""
        cfg, engine = self.cfg, self._engine
        requests = self.chunks * cfg.chunk_len
        if cfg.fast:
            hits = int(engine.hits)
            state = self.states()[0]
            as_row = lambda v: torch.as_tensor([v], dtype=torch.int32, device=self.device)
            tier = {"requests": as_row(requests), "hits": as_row(hits), "count": state["count"][None]}
            if "inserts" in state:
                tier["inserts"] = state["inserts"][None]
                tier["evictions"] = tier["inserts"] - tier["count"]
            return StreamStats(requests=requests, chunks=self.chunks, chunk_len=cfg.chunk_len, hits=hits,
                               origin_misses=requests - hits, tiers=(tier,), elapsed_s=elapsed_s)
        origin = int(engine.origin)
        telemetry = pressure = None
        if self._series is not None:
            telemetry = tuple(torch.cat(chunks, dim=1) for chunks in self._series)
        if self._pressure is not None:
            pressure = tuple(torch.cat(chunks, dim=1) for chunks in self._pressure)
        return StreamStats(requests=requests, chunks=self.chunks, chunk_len=cfg.chunk_len, hits=requests - origin,
                           origin_misses=origin, tiers=engine.tiers(), elapsed_s=elapsed_s, telemetry=telemetry,
                           telemetry_pressure=pressure)


def stream_fleet(cfg: StreamConfig, dspec: device_mod.DeviceTraceSpec, n_chunks: int, *, sample: int = 0,
                 sizes=None, groups=None, device=None, stream: FleetStream | None = None) -> StreamStats:
    """Run ``n_chunks`` chunks of sample ``sample``'s generated stream
    (``dspec.trace_len`` is the chunk length and must equal
    ``cfg.chunk_len``), double-buffered: on the card chunk ``c + 1`` is
    generated on a side CUDA stream while chunk ``c`` is pushed, and the
    main stream waits on the side stream's event before it reads it; on the
    CPU generation and push alternate. Returns the :class:`StreamStats`
    rollup with the measured wall clock (requests/s and J a request over
    generation and simulation). ``stream`` pushes into that
    :class:`FleetStream` of ``cfg`` (whose states the caller can then read)
    instead of a new one."""
    if dspec.trace_len != cfg.chunk_len:
        raise ValueError(f"dspec.trace_len ({dspec.trace_len}) must equal cfg.chunk_len ({cfg.chunk_len})")
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if stream is not None and stream.cfg != cfg:
        raise ValueError("stream was built for another StreamConfig")
    fs = FleetStream(cfg, sizes=sizes, groups=groups, device=device) if stream is None else stream
    dev = fs.device
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def generate(c: int):
        if side is None:
            return device_mod.gen_stream_chunk(dspec, sample, c, dev), None
        with torch.cuda.stream(side):
            chunk = device_mod.gen_stream_chunk(dspec, sample, c, dev)
            done = torch.cuda.Event()
            done.record(side)
        return chunk, done

    nxt = generate(0)
    start = time.perf_counter()
    for c in range(n_chunks):
        cur, done = nxt
        if done is not None:
            main = torch.cuda.current_stream(dev)
            main.wait_event(done)
            cur.record_stream(main)  # the allocator must not hand its memory out before main has read it
        if c + 1 < n_chunks:
            nxt = generate(c + 1)
        fs.push(cur)
    fs.block()
    elapsed = time.perf_counter() - start
    return fs.stats(elapsed_s=elapsed)
