"""Multi-device fleet runs over the ranks of a ``torch.distributed`` process group.

Two shardings of :func:`repro_torch.fleet.sim.simulate_fleet`, over a 1-D
``DeviceMesh`` whose ranks are one process a device (the reference's mesh is
over the local devices of one process; this one is over processes):

* **Edge-sharded** (:func:`simulate_fleet_sharded`): rank ``r`` runs its
  contiguous ``E / D`` edges over the whole trace, one all-reduce rebuilds
  the global edge-served mask, and the upper levels (small) run replicated on
  every rank on exactly the fleet-wide miss stream. A placed topology runs
  the time-major engine with the rank's edges and one all-reduce a position
  (the probe's edge-served bit). Every rank returns the whole single-device
  result, the edge rows gathered, so callers compare it directly.

* **Sample-sharded** (:func:`simulate_fleet_device`): rank ``r`` generates
  its contiguous share of the global sample ids on its device, routes them
  and simulates each one's whole topology; every rank returns all samples.
  A sample's stream is a pure function of (seed, global sample id), so the
  sharding does not change results.

Both run the single-process engine when no mesh (or a one-rank mesh) is
given. Collectives go through the mesh's process group; where its backend is
gloo and an operand lies on the card, the operand alone is staged through the
host (the simulation stays on the card), so the placed edge-sharded run is
then one host round trip a position.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch._device import arange, resolve_device
from repro_torch.fleet import sim as sim_mod
from repro_torch.fleet.topology import Topology
from repro_torch.workloads.device import DeviceTraceSpec, gen_sample, sample_key

__all__ = [
    "fleet_mesh",
    "mesh_size",
    "simulate_fleet_sharded",
    "simulate_fleet_device",
]

AXIS = "shards"


def fleet_mesh(device=None, axis: str = AXIS):
    """A 1-D ``DeviceMesh`` over every rank of the default process group (one
    rank a device), of ``device``'s type (the card unless ``"cpu"``). The
    caller initialises the group (``init_process_group`` with its address,
    world size and rank)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("fleet_mesh needs an initialised default process group (init_process_group)")
    return DeviceMesh(resolve_device(device).type, torch.arange(dist.get_world_size()), mesh_dim_names=(axis,))


def mesh_size(mesh) -> int:
    """Ranks of a mesh (1 for ``None``)."""
    return 1 if mesh is None else int(mesh.size())


class _Group:
    """A mesh's process group and the collectives of a sharded run. A gloo
    group takes no CUDA tensor here: the operand is copied to the host, the
    collective runs there, and the result is copied back."""

    def __init__(self, mesh):
        self.group = mesh.get_group(0)
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.staged = dist.get_backend(self.group) == "gloo"
        self.offset = 0  # the rank's first edge, in an edge-sharded run

    def _operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.uint8) if t.dtype == torch.bool else t
        return t.to("cpu", copy=True) if self.staged or t.device.type == "cpu" else t.clone()

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) of ``t`` over the group, on ``t``'s device."""
        buf = self._operand(t).contiguous()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.to(t.device)

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order, on
        ``t``'s device (the shapes must agree)."""
        buf = self._operand(t).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        out = torch.cat(parts, dim=dim).to(t.device)
        return out.bool() if t.dtype == torch.bool else out


def _edge_share(topo: Topology, grp: _Group) -> tuple[int, tuple]:
    """The rank's first edge and its contiguous slice of the edge specs."""
    specs0 = topo.levels[0]
    e_n, d_n = len(specs0), grp.size
    if e_n % d_n:
        raise ValueError(f"edge count {e_n} must divide over the {d_n}-device mesh")
    n_local = e_n // d_n
    grp.offset = grp.rank * n_local
    return grp.offset, specs0[grp.offset: grp.offset + n_local]


def _level_major_sharded(topo: Topology, traces, assigns, grp: _Group, local_specs) -> dict:
    """The rank's edges through ``masked_scan``, one all-reduce for the
    served mask, the upper levels replicated, the edge rows gathered."""
    offset, n_local = grp.offset, len(local_specs)
    own = (assigns[0] >= offset) & (assigns[0] < offset + n_local)
    states, hits, _ = sim_mod.run_level(local_specs, traces, assigns[0] - offset, own)
    # one collective rebuilds the global served mask (one rank owns each request's edge)
    served = grp.sum(hits.any(dim=1).to(torch.int32)) > 0
    hits_up, counters_up, states_up, demand = sim_mod.upper_levels(topo, traces, assigns, ~served)
    edge_hits = grp.gather(hits, dim=1)
    edge_states = {k: grp.gather(v, dim=1) for k, v in states.items()}
    e_n = len(topo.levels[0])
    active0 = assigns[0].unsqueeze(1) == arange(e_n, traces.device)[:, None]
    all_hits = [edge_hits, *hits_up]
    return {
        "hit": tuple(h.any(dim=1) for h in all_hits),
        "node_hit": tuple(all_hits),
        "tiers": (sim_mod.tier_counters(topo.levels[0][0], edge_hits, active0, traces, edge_states), *counters_up),
        "states": (edge_states, *states_up),
        "origin_miss": demand,
    }


def _placed_sharded(topo: Topology, traces, assigns, grp: _Group, local_specs) -> dict:
    """The time-major engine with the rank's edges (one all-reduce a
    position), then the edge level's states, placement sketches and stored
    bits gathered and the result assembled as on one device."""
    dev = traces.device
    offset, n_local = grp.offset, len(local_specs)
    level0 = {k: v[0] for k, v in sim_mod.stack_level_state(local_specs, 1, dev).items()}
    carry, records, _, _ = sim_mod._placed_run(topo, traces, assigns, level0_states=level0,
                                               level0_caps=[s.capacity for s in local_specs], edge_group=grp)
    # x's membership after the edge step is known to the rank that owns the edge
    own = ((assigns[0] >= offset) & (assigns[0] < offset + n_local)).t()
    records[0]["stored"] = grp.sum((records[0]["stored"] & own).to(torch.int32)) > 0

    def whole(v):
        rows = grp.gather(v[:n_local], dim=0)
        return torch.cat([rows, rows[:1]])  # and a spare row, as the engine's carry

    pstates = dict(carry["pstates"])
    if 0 in pstates:
        pstates[0] = {k: whole(v) for k, v in pstates[0].items()}
    full = {"states": [{k: whole(v) for k, v in carry["states"][0].items()}, *carry["states"][1:]],
            "pstates": pstates}
    return sim_mod.assemble_placed(topo, traces, assigns, full, records)


def simulate_fleet_sharded(topo: Topology, trace, assignment, mesh=None, *, device=None) -> dict:
    """Edge-sharded fleet run over ``mesh``'s ranks; every rank returns the
    whole ``simulate_fleet`` result. Runs ``simulate_fleet`` when ``mesh``
    is absent or has one rank. A placed topology runs the time-major engine
    over the rank's edges (one all-reduce a position); byte-capacity levels
    are refused there. Raises when the edges do not divide over the ranks."""
    if mesh_size(mesh) == 1:
        return sim_mod.simulate_fleet(topo, trace, assignment, device=device)
    grp = _Group(mesh)
    _, local_specs = _edge_share(topo, grp)
    traces, assignments, _ = sim_mod._check_inputs(topo, torch.as_tensor(trace)[None],
                                                   torch.as_tensor(assignment)[None], None, None, device)
    assigns = sim_mod.level_assignments(topo, traces, assignments)
    if topo.has_placement:
        out = _placed_sharded(topo, traces, assigns, grp, local_specs)
    else:
        out = _level_major_sharded(topo, traces, assigns, grp, local_specs)
    return sim_mod._map(lambda v: v[0], out)


def simulate_fleet_device(topo: Topology, dspec: DeviceTraceSpec, *, mesh=None, route_seed: int = 0, device=None):
    """Generation on the device and simulation, optionally sample-sharded:
    rank ``r`` generates its contiguous share of the ``dspec.n_samples``
    sample ids (``gen_sample(dspec, sample_key(dspec, sid))``), routes each
    with ``route_device(..., seed=route_seed)`` and simulates them. Returns
    ``(result, traces, assignments)`` on every rank: the batched
    ``simulate_fleet`` result and the ``(S, T)`` traces and assignments of
    all samples. Raises when the samples do not divide over the ranks."""
    from repro_torch.cdn.router import route_device  # cdn imports the topology

    dev = resolve_device(device)
    s_n = dspec.n_samples
    grp = None if mesh_size(mesh) == 1 else _Group(mesh)
    if grp is None:
        sids = range(s_n)
    else:
        if s_n % grp.size:
            raise ValueError(f"n_samples {s_n} must divide over the {grp.size}-device mesh")
        share = s_n // grp.size
        sids = range(grp.rank * share, (grp.rank + 1) * share)
    traces = torch.stack([gen_sample(dspec, sample_key(dspec, sid), dev) for sid in sids])
    assignments = torch.stack([route_device(tr, topo.n_edges, topo.router, session_len=topo.session_len,
                                            seed=route_seed) for tr in traces])
    result = sim_mod._simulate_fleet_impl(topo, traces, assignments, device=dev)
    if grp is None:
        return result, traces, assignments
    gather = lambda v: grp.gather(v, dim=0)
    return sim_mod._map(gather, result), gather(traces), gather(assignments)
