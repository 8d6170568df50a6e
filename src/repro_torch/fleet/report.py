"""Per-tier roll-ups for fleet topologies: CHR, evictions, management cost
and energy, rolled up the tier tree.

The port's copy of the reference package's report module; it reads the fleet
engine's torch outputs, on the card or the CPU, by moving them to the host.
The paper prices a cache by the CPU time its *management loop* burns
(:func:`repro_torch.core.energy.mgmt_energy_j` converts that to Joules at one
Xeon-core TDP share). The fleet engine counts decisions, not seconds, so this
module carries a coarse operation-count model per policy kind — dict/heap
touches per request plus the eviction inner loop, with the paper's two cost
profiles:

  * ``heap`` — lazy min-heap eviction, O(log C) per eviction;
  * ``scan`` — O(C) linear-scan eviction (the paper's §3 profile).

``per_op_s`` calibrates an "operation" to seconds; the default 1e-7 s (~100 ns
per dict/heap touch on the paper's Xeon Gold 6130) is a parameter, not a
claim.

Cross-tier placement (``Topology.placements``) is priced as a distinct row
per level (``<level>:placement``): the fill-path writes each stored copy
costs, plus the decision machinery (``prob``'s hash, ``admit``'s count-min
duel).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import energy, sketch
from repro_torch.core.torch_cache import PolicySpec
from repro_torch.fleet import placement as placement_mod
from repro_torch.fleet.topology import Topology

__all__ = [
    "TierReport",
    "FleetReport",
    "TIER_ROW_FIELDS",
    "TENANT_ROW_FIELDS",
    "aggregate_tiers",
    "mgmt_ops",
    "placement_ops",
    "fleet_report",
    "tier_report",
]

#: the pinned TierReport.row() schema — key order and units are load-bearing
#: (exporters and downstream spreadsheets key on them; the reference's tuple).
#: counts are totals over the report's scope (batch-summed), ``chr`` is a
#: ratio in [0, 1], ``mgmt_cpu_s`` seconds, ``mgmt_energy_j`` Joules.
TIER_ROW_FIELDS = (
    "tier",
    "policy",
    "capacity",
    "requests",
    "hits",
    "chr",
    "req_bytes",
    "hit_bytes",
    "byte_chr",
    "evictions",
    "mgmt_ops",
    "mgmt_cpu_s",
    "mgmt_energy_j",
)

#: the pinned FleetReport.tenant_rows() schema — one row per tenant
#: group, derived from the group-segmented windowed series. Counts are
#: totals over the report's scope; ``chr``/``byte_chr``/``hot_share`` are
#: ratios in [0, 1]; the latency columns are µs under the report's
#: LatencyModel (p50/p99 are exact discrete inverse-CDF reads over the
#: per-level serving histogram, not sampled estimates).
TENANT_ROW_FIELDS = (
    "tenant",
    "requests",
    "hits",
    "chr",
    "req_bytes",
    "hit_bytes",
    "byte_chr",
    "egress_bytes",
    "p50_us",
    "p99_us",
    "mean_us",
    "eviction_pressure",
    "hot_share",
)

#: dict/heap touches charged per processed request, by policy kind. Sketch
#: kinds additionally pay core.sketch.DEPTH counter updates on every request
#: (the TinyLFU "O(1) admission" price), charged separately below.
_REQ_OPS = {
    "lru": 3.0,
    "lfu": 3.0,
    "plfu": 3.0,
    "plfua": 1.0,
    "wlfu": 5.0,
    "tinylfu": 3.0,
    "plfua_dyn": 1.0,
    # GDSF touches freq + score dicts and pushes the recomputed priority on
    # every request (the L + freq/size ratchet), one touch more than plain lfu
    "gdsf": 4.0,
    # ARC probes the four-list directory, moves the id to its target list's
    # MRU, and adjusts p / trims a ghost on the miss path — list moves are
    # O(1), so it prices like lru plus the extra directory bookkeeping touch
    "arc": 4.0,
}
#: extra touches per *admitted* request (the PLFUA family meters metadata work
#: only for the hot set — that asymmetry is the paper's §4 energy argument).
_ADMITTED_OPS = {"plfua": 3.0, "plfua_dyn": 3.0}

#: placement cost model (the fill path's own management work, priced as a
#: distinct row per level so cross-tier placement trade-offs are visible):
#: every fill writes the copy's index/bookkeeping entry; a ``prob`` decision
#: pays one hash; an ``admit`` decision pays the count-min duel (the sketch
#: feed on every consulted request plus two estimates per decision and the
#: amortised halving — same convention as the tinylfu rows above).
_PLACEMENT_WRITE_OPS = 2.0
_PROB_DECISION_OPS = 1.0


def placement_ops(
    pl: str,
    level_specs: tuple[PolicySpec, ...],
    requests: float,
    hits: float,
    inserts: float,
) -> float:
    """Abstract placement-operation count for one level (aggregate).

    ``requests - hits`` is the number of placement *decisions* (every
    consulted miss is offered the object on the fill path, whatever tier
    ends up serving it); ``inserts`` is the number of fills actually
    performed."""
    kind, _ = placement_mod.parse(pl)
    decisions = max(0.0, requests - hits)
    ops = _PLACEMENT_WRITE_OPS * inserts
    if kind == "prob":
        ops += _PROB_DECISION_OPS * decisions
    elif kind == "admit":
        width, window = placement_mod.admit_params(level_specs)
        ops += float(sketch.DEPTH) * requests  # feed on every consult
        ops += 2.0 * float(sketch.DEPTH) * decisions  # the duel's estimates
        ops += requests / window * float(sketch.DEPTH * width)  # aging
    return float(ops)


def mgmt_ops(
    spec: PolicySpec,
    requests: float,
    admitted_requests: float,
    evictions: float,
    cost_model: str = "heap",
    global_requests: float | None = None,
) -> float:
    """Abstract management-operation count for one tier node.

    ``global_requests`` is the total request count across the whole fleet
    (trace steps x samples). plfua_dyn's hot-set refresh runs on *global*
    time — every instance refreshes once per ``refresh`` trace positions no
    matter how few requests were routed to it — so its amortised refresh cost
    scales with global, not tier-local, requests. Defaults to ``requests``
    (correct for a flat single cache). TinyLFU aging really is driven by the
    per-instance request counter, so it stays on ``requests``.
    """
    if cost_model not in ("heap", "scan"):
        raise ValueError(f"cost_model must be 'heap' or 'scan', got {cost_model!r}")
    per_evict = (
        float(spec.capacity)
        if (cost_model == "scan" or spec.kind == "wlfu")  # wlfu heap is invalid
        else math.log2(max(2.0, spec.capacity))
    )
    ops = _REQ_OPS[spec.kind] * requests
    ops += _ADMITTED_OPS.get(spec.kind, 0.0) * admitted_requests
    ops += per_evict * evictions
    if spec.kind == "tinylfu":
        # per-request sketch counter updates (one per row), plus amortised
        # aging: halving DEPTH x width counters once per window. A doorkeeper
        # front swaps the sketch touch for BLOOM_DEPTH bit probes on the
        # (gated) first touch — modelled as bloom probes on every request plus
        # the amortised per-window bloom clear.
        ops += float(sketch.DEPTH) * requests
        ops += requests / spec.effective_window * float(
            sketch.DEPTH * spec.effective_sketch_width
        )
        if spec.doorkeeper:
            ops += float(sketch.BLOOM_DEPTH) * requests
            ops += requests / spec.effective_window * float(spec.doorkeeper)
    if spec.kind == "plfua_dyn":
        ops += float(sketch.DEPTH) * requests
        # amortised global-time refresh, at the model's DEPTH-touches-per-
        # sketch-access convention: estimate-all reads DEPTH counters per
        # object, plus the halving over the whole DEPTH x width table
        g = requests if global_requests is None else global_requests
        ops += g / spec.effective_refresh * float(
            sketch.DEPTH * (spec.n_objects + spec.effective_sketch_width)
        )
    return float(ops)


@dataclasses.dataclass
class TierReport:
    tier: str  # "edge[i]" | "edge" (aggregate) | "parent" | "mid1[j]" | ...
    policy: str
    capacity: int
    requests: int
    hits: int
    evictions: int
    mgmt_ops: float
    mgmt_cpu_s: float
    mgmt_energy_j: float
    #: traffic weighted by object size; unit fallback (no size catalogue on
    #: the run) keeps req_bytes == requests and hit_bytes == hits, so byte_chr
    #: degenerates to chr and the row schema never forks on sizedness
    req_bytes: int = 0
    hit_bytes: int = 0

    @property
    def chr(self) -> float:
        return self.hits / self.requests if self.requests else 0.0

    @property
    def byte_chr(self) -> float:
        return self.hit_bytes / self.req_bytes if self.req_bytes else 0.0

    def row(self) -> dict:
        # built from TIER_ROW_FIELDS so the emitted keys cannot drift from the schema
        return {f: getattr(self, f) for f in TIER_ROW_FIELDS}


def tier_report(
    name: str,
    spec: PolicySpec,
    c: dict[str, Any],
    cost_model: str,
    per_op_s: float,
    global_requests: float | None = None,
) -> TierReport:
    """One node's counters -> a priced TierReport."""
    ops = mgmt_ops(
        spec,
        float(c["requests"]),
        float(c["admitted_requests"]),
        float(c["evictions"]),
        cost_model,
        global_requests=global_requests,
    )
    cpu_s = ops * per_op_s
    return TierReport(
        tier=name,
        policy=spec.kind,
        capacity=spec.capacity,
        requests=int(c["requests"]),
        hits=int(c["hits"]),
        evictions=int(c["evictions"]),
        mgmt_ops=ops,
        mgmt_cpu_s=cpu_s,
        mgmt_energy_j=energy.mgmt_energy_j(cpu_s),
        req_bytes=int(c.get("req_bytes", c["requests"])),
        hit_bytes=int(c.get("hit_bytes", c["hits"])),
    )


def aggregate_tiers(name: str, policy: str, capacity: int, nodes: list[TierReport]) -> TierReport:
    """Sum a list of node TierReports into one aggregate row."""
    return TierReport(
        tier=name,
        policy=policy,
        capacity=capacity,
        requests=sum(t.requests for t in nodes),
        hits=sum(t.hits for t in nodes),
        evictions=sum(t.evictions for t in nodes),
        mgmt_ops=sum(t.mgmt_ops for t in nodes),
        mgmt_cpu_s=sum(t.mgmt_cpu_s for t in nodes),
        mgmt_energy_j=sum(t.mgmt_energy_j for t in nodes),
        req_bytes=sum(t.req_bytes for t in nodes),
        hit_bytes=sum(t.hit_bytes for t in nodes),
    )


@dataclasses.dataclass
class FleetReport:
    """Tree-level view of one simulated trace (or the sum over a batch)."""

    per_node: list[list[TierReport]]  # [level][node]
    per_level: list[TierReport]  # aggregate per level
    n_requests: int
    origin_requests: int  # missed every tier -> fetched from origin
    #: bytes fetched from origin (edge request bytes minus every tier's hit
    #: bytes); unit fallback makes this == origin_requests
    origin_egress_bytes: int = 0
    #: one row per level pricing the cross-tier placement machinery (fill
    #: writes + decision cost; see placement_ops). ``requests`` on these
    #: rows counts placement decisions, ``hits``/``evictions`` are 0.
    per_level_placement: list[TierReport] = dataclasses.field(default_factory=list)
    #: per-level windowed telemetry, batch-summed to ``(n_nodes, n_windows,
    #: N_METRICS)`` per level — present when fleet_report was handed the run's
    #: TelemetrySpec (see window_rows). Group-segmented runs keep the
    #: group axis: ``(n_nodes, n_windows, n_groups, N_METRICS)``.
    per_level_series: list[np.ndarray] | None = None
    telemetry_window: int | None = None
    #: tenant groups on the run's TelemetrySpec (0 = ungrouped)
    n_groups: int = 0
    #: per-level cross-tenant eviction pressure, batch-summed to
    #: ``(n_nodes, n_windows, n_groups)`` — evictions of a group's objects
    #: triggered by *another* group's request (grouped runs only)
    per_level_pressure: list[np.ndarray] | None = None

    @property
    def level_chr(self) -> list[float]:
        return [t.chr for t in self.per_level]

    @property
    def edge_chr(self) -> float:
        return self.per_level[0].chr

    @property
    def total_chr(self) -> float:
        """Served from *some* cache tier."""
        if not self.n_requests:
            return 0.0
        return sum(t.hits for t in self.per_level) / self.n_requests

    @property
    def mgmt_ops(self) -> float:
        return sum(t.mgmt_ops for t in self.per_level) + self.placement_ops

    @property
    def mgmt_cpu_s(self) -> float:
        return sum(t.mgmt_cpu_s for t in self.per_level) + sum(
            t.mgmt_cpu_s for t in self.per_level_placement
        )

    @property
    def mgmt_energy_j(self) -> float:
        return sum(t.mgmt_energy_j for t in self.per_level) + sum(
            t.mgmt_energy_j for t in self.per_level_placement
        )

    @property
    def placement_ops(self) -> float:
        return sum(t.mgmt_ops for t in self.per_level_placement)

    @property
    def placement_energy_j(self) -> float:
        return sum(t.mgmt_energy_j for t in self.per_level_placement)

    @property
    def byte_chr(self) -> float:
        """Fleet-wide byte hit ratio: bytes served from *some* cache tier."""
        rb = self.per_level[0].req_bytes if self.per_level else 0
        if not rb:
            return 0.0
        return sum(t.hit_bytes for t in self.per_level) / rb

    @property
    def origin_egress_gb(self) -> float:
        """GB pulled over the origin link (the paper's traffic-cost axis)."""
        return self.origin_egress_bytes / 1e9

    def rows(self) -> list[dict]:
        out = []
        pls = self.per_level_placement or [None] * len(self.per_level)
        for lvl, agg, pl in zip(self.per_node, self.per_level, pls):
            out.extend(t.row() for t in lvl)
            out.append(agg.row())
            if pl is not None:
                out.append(pl.row())
        # the origin summary row: what the cache fleet did NOT absorb. Keyed
        # on the pinned schema plus one extra column (the exporter takes the
        # ordered union across rows, so the extra key is safe).
        origin = TierReport(
            tier="origin",
            policy="-",
            capacity=0,
            requests=self.origin_requests,
            hits=0,
            evictions=0,
            mgmt_ops=0.0,
            mgmt_cpu_s=0.0,
            mgmt_energy_j=0.0,
            req_bytes=self.origin_egress_bytes,
            hit_bytes=0,
        ).row()
        origin["origin_egress_gb"] = self.origin_egress_gb
        out.append(origin)
        return out

    def window_rows(self) -> list[dict]:
        """Per-(node, window) telemetry rows — repro_torch.telemetry.export shape,
        tagged with the level name and policy. Requires the report to have
        been built with ``fleet_report(..., telemetry=spec)``."""
        if self.per_level_series is None:
            raise ValueError(
                "no windowed telemetry on this report; run the fleet with a "
                "TelemetrySpec and pass it to fleet_report(..., telemetry=...)"
            )
        from repro_torch.telemetry import export

        rows: list[dict] = []
        for nodes, agg, series in zip(
            self.per_node, self.per_level, self.per_level_series
        ):
            rows.extend(
                export.series_rows(
                    series,
                    self.telemetry_window,
                    labels=[t.tier for t in nodes],
                    grouped=self.n_groups > 0,
                    level=agg.tier,
                    policy=agg.policy,
                )
            )
        return rows

    def tenant_rows(self, latency=None) -> list[dict]:
        """Per-tenant SLO rows (the :data:`TENANT_ROW_FIELDS` schema) from a
        group-segmented run.

        Every request enters at the edge, so a tenant's request/byte totals
        are the edge level's grouped counters; its hits are summed over all
        serving levels and the remainder went to origin. Those per-level
        serve counts *are* the latency histogram under ``latency`` (a
        :class:`repro_torch.telemetry.LatencyModel`; default: the deterministic
        ladder ``LatencyModel.default(n_levels)``), so p50/p99/mean are
        exact. ``eviction_pressure`` totals the cross-tenant evictions the
        run recorded against each tenant; ``hot_share`` is the tenant's
        share of fleet-wide cached objects in the final window.
        """
        if self.per_level_series is None or not self.n_groups:
            raise ValueError(
                "tenant_rows needs group-segmented telemetry; run the fleet "
                "with TelemetrySpec(window, n_groups) + a groups catalogue "
                "and pass the spec to fleet_report(..., telemetry=...)"
            )
        from repro_torch.telemetry import LatencyModel
        from repro_torch.telemetry.spec import METRIC_INDEX

        L = len(self.per_level_series)
        if latency is None:
            latency = LatencyModel.default(L)
        if latency.n_levels != L:
            raise ValueError(
                f"latency model has {latency.n_levels} levels, fleet has {L}"
            )
        # (L, G) per-level grouped totals; edge carries the demand axis
        hits_lg = np.stack(
            [s[..., METRIC_INDEX["hits"]].sum(axis=(0, 1)) for s in self.per_level_series]
        )
        hit_bytes_lg = np.stack(
            [s[..., METRIC_INDEX["hit_bytes"]].sum(axis=(0, 1)) for s in self.per_level_series]
        )
        edge = self.per_level_series[0]
        req_g = edge[..., METRIC_INDEX["requests"]].sum(axis=(0, 1))
        req_bytes_g = (
            edge[..., METRIC_INDEX["hit_bytes"]].sum(axis=(0, 1))
            + edge[..., METRIC_INDEX["miss_bytes"]].sum(axis=(0, 1))
        )
        origin_g = req_g - hits_lg.sum(axis=0)
        egress_g = req_bytes_g - hit_bytes_lg.sum(axis=0)
        # final-window fleet-wide occupancy census per group
        occ_g = sum(
            s[:, -1, :, METRIC_INDEX["occupancy"]].sum(axis=0)
            for s in self.per_level_series
        )
        occ_total = float(occ_g.sum())
        if self.per_level_pressure is not None:
            pressure_g = sum(p.sum(axis=(0, 1)) for p in self.per_level_pressure)
        else:
            pressure_g = np.zeros(self.n_groups, np.int64)
        rows = []
        for g in range(self.n_groups):
            hist = np.concatenate([hits_lg[:, g], [origin_g[g]]])
            total_hits = int(hits_lg[:, g].sum())
            rows.append({
                "tenant": g,
                "requests": int(req_g[g]),
                "hits": total_hits,
                "chr": total_hits / int(req_g[g]) if req_g[g] else 0.0,
                "req_bytes": int(req_bytes_g[g]),
                "hit_bytes": int(hit_bytes_lg[:, g].sum()),
                "byte_chr": (
                    int(hit_bytes_lg[:, g].sum()) / int(req_bytes_g[g])
                    if req_bytes_g[g] else 0.0
                ),
                "egress_bytes": int(egress_g[g]),
                "p50_us": latency.percentile(hist, 0.5),
                "p99_us": latency.percentile(hist, 0.99),
                "mean_us": latency.mean_us(hist),
                "eviction_pressure": int(pressure_g[g]),
                "hot_share": float(occ_g[g]) / occ_total if occ_total else 0.0,
            })
            assert tuple(rows[-1].keys()) == TENANT_ROW_FIELDS
        return rows


def _host(v) -> np.ndarray:
    """A result's tensor (on any device) or array as a host numpy array."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def fleet_report(
    topo: Topology,
    result: dict[str, Any],
    *,
    cost_model: str = "heap",
    per_op_s: float = 1e-7,
    telemetry=None,
) -> FleetReport:
    """Roll up one ``simulate_fleet`` result (on the host, in numpy).

    For batched results (leading sample axis from ``simulate_fleet_batch``)
    counters are summed over samples — i.e. the report covers the whole batch.

    ``telemetry`` is the run's TelemetrySpec: when the result carries the
    in-scan windowed series (``result["telemetry"]``, one array per level),
    the report keeps them batch-summed per node and ``window_rows()`` exports
    the per-(node, window) view.
    """
    names = topo.names
    # total trace steps across the batch: every request hits exactly one edge
    edge_req = _host(result["tiers"][0]["requests"])
    total_steps = float(edge_req.sum())
    per_node: list[list[TierReport]] = []
    per_level: list[TierReport] = []
    per_level_placement: list[TierReport] = []
    for l, specs in enumerate(topo.levels):
        c = {k: _host(v) for k, v in result["tiers"][l].items()}
        # collapse an optional sample axis, keeping the node axis (always last)
        c = {k: v.reshape(-1, v.shape[-1]).sum(0) for k, v in c.items()}
        nodes = [
            tier_report(
                f"{names[l]}[{i}]",
                specs[i],
                {k: c[k][i] for k in c},
                cost_model,
                per_op_s,
                global_requests=total_steps,
            )
            for i in range(len(specs))
        ]
        per_node.append(nodes)
        cap = sum(s.capacity for s in specs)
        per_level.append(
            aggregate_tiers(names[l], specs[0].kind, cap, nodes)
        )
        # the distinct placement row: fill writes + decision machinery
        requests = float(c["requests"].sum())
        hits = float(c["hits"].sum())
        inserts = float(c["inserts"].sum())
        p_ops = placement_ops(
            topo.placements[l], specs, requests, hits, inserts
        )
        p_cpu = p_ops * per_op_s
        per_level_placement.append(
            TierReport(
                tier=f"{names[l]}:placement",
                policy=topo.placements[l],
                capacity=cap,
                requests=int(requests - hits),  # placement decisions
                hits=0,
                evictions=0,
                mgmt_ops=p_ops,
                mgmt_cpu_s=p_cpu,
                mgmt_energy_j=energy.mgmt_energy_j(p_cpu),
                req_bytes=int(requests - hits),  # unit fallback: 1 per decision
                hit_bytes=0,
            )
        )
    n_requests = per_level[0].requests
    origin = n_requests - sum(t.hits for t in per_level)
    origin_bytes = per_level[0].req_bytes - sum(t.hit_bytes for t in per_level)
    per_level_series = None
    per_level_pressure = None
    n_groups = 0 if telemetry is None else getattr(telemetry, "n_groups", 0)
    if telemetry is not None:
        if "telemetry" not in result:
            raise ValueError(
                "telemetry= given but the result carries no windowed series; "
                "run simulate_fleet(..., telemetry=spec) first"
            )
        per_level_series = []
        # grouped series carry one extra trailing axis before N_METRICS
        keep = 4 if n_groups else 3
        for l, arr in enumerate(result["telemetry"]):
            a = _host(arr)
            # collapse any batch axes down to (n_nodes, n_windows, [n_groups,]
            # N_METRICS); counters sum over samples like the scalar tier
            # counters above
            a = a.reshape((-1,) + a.shape[-keep:]).sum(axis=0)
            if a.shape[0] != len(topo.levels[l]):
                raise ValueError(
                    f"level {l} series has {a.shape[0]} nodes, topology has "
                    f"{len(topo.levels[l])}"
                )
            per_level_series.append(a)
        if n_groups and "telemetry_pressure" in result:
            per_level_pressure = [
                _host(p).reshape((-1,) + tuple(p.shape[-3:])).sum(axis=0) for p in result["telemetry_pressure"]
            ]
    return FleetReport(
        per_node=per_node,
        per_level=per_level,
        n_requests=n_requests,
        origin_requests=origin,
        origin_egress_bytes=origin_bytes,
        per_level_placement=per_level_placement,
        per_level_series=per_level_series,
        telemetry_window=None if telemetry is None else telemetry.window,
        n_groups=n_groups,
        per_level_pressure=per_level_pressure,
    )
