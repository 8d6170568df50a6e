"""Request routing: which node of a tier serves each request of a trace.

The port's copy of the reference package's router. Three partitioning
schemes, each a deterministic function of the trace, so the fleet engine and
the pure-Python oracle see the same assignment:

  * ``hash``        — content-addressed: node = mix(object_id) % E. Each object
                      lives on exactly one node, so the tier behaves like one
                      partitioned cache.
  * ``sticky``      — client-session affinity: consecutive requests form
                      sessions of ``session_len``; each session hashes to a
                      node. Objects replicate across nodes.
  * ``round_robin`` — load-balanced spraying: request t -> node t % E.

:func:`route` is the host's 64-bit edge router (numpy). :func:`route_level`
is the 32-bit (lowbias32) per-level router, on numpy arrays or torch
tensors with bit-identical partitions; torch has no complete uint32
arithmetic, so its path computes in int64 masked to 32 bits.
:func:`route_device` is :func:`route_level` on a tensor, :func:`route_point`
one request of it on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import sketch

ROUTER_MODES = ("hash", "sticky", "round_robin")

#: per-level router sentinel: follow the topology's static parent map instead
#: of routing (valid for every level but the edge tier); see
#: ``repro_torch.fleet.Topology.routers``
TREE = "tree"
LEVEL_ROUTER_MODES = ROUTER_MODES + (TREE,)

_SEED_STRIDE = 1_000_003
_U32 = 0xFFFFFFFF

_MIX_MULT = np.uint64(0xFF51AFD7ED558CCD)
_MIX_MULT2 = np.uint64(0xC4CEB9FE1A85EC53)


def _mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64-style avalanche; uniform over uint64 for sequential inputs."""
    h = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(33)
    h *= _MIX_MULT
    h ^= h >> np.uint64(33)
    h *= _MIX_MULT2
    h ^= h >> np.uint64(33)
    return h


def _check_mode(mode: str, session_len: int) -> None:
    if mode not in ROUTER_MODES:
        raise ValueError(f"unknown router mode {mode!r}; expected one of {ROUTER_MODES}")
    if mode == "sticky" and session_len < 1:
        raise ValueError(f"session_len must be >= 1, got {session_len}")


def route(trace: np.ndarray, n_edges: int, mode: str = "hash", *, session_len: int = 64,
          seed: int = 0) -> np.ndarray:
    """Edge assignment for every request of ``trace`` (last axis = time),
    int32 ``(T,)`` or ``(S, T)``."""
    if n_edges < 1:
        raise ValueError(f"n_edges must be >= 1, got {n_edges}")
    _check_mode(mode, session_len)
    trace = np.asarray(trace)
    t = trace.shape[-1]
    if mode == "round_robin":
        assign = np.broadcast_to(np.arange(t, dtype=np.int64) % n_edges, trace.shape)
    elif mode == "hash":
        assign = _mix64(trace.astype(np.int64) + np.int64(seed) * np.int64(_SEED_STRIDE)) % np.uint64(n_edges)
    else:
        block = np.arange(t, dtype=np.int64) // session_len
        assign = _mix64(block + np.int64(seed) * np.int64(_SEED_STRIDE)) % np.uint64(n_edges)
        assign = np.broadcast_to(assign, trace.shape)
    return np.ascontiguousarray(assign.astype(np.int32))


def _salt(seed: int) -> int:
    return (int(seed) * _SEED_STRIDE) & _U32


def route_level(trace, n_nodes: int, mode: str = "hash", *, session_len: int = 64, seed: int = 0):
    """32-bit router over one tier's ``n_nodes`` nodes: int32 node ids shaped
    like ``trace``, a numpy array or a torch tensor (then on its device), the
    two bit-identical. The fleet's routed upper tiers take their assignment
    from it, and the oracle replays the same one on the host."""
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    _check_mode(mode, session_len)
    if isinstance(trace, torch.Tensor):
        return _route_level_torch(trace, n_nodes, mode, session_len, seed)
    trace = np.asarray(trace)
    t = trace.shape[-1]
    salt = np.uint32(_salt(seed))
    if mode == "round_robin":
        assign = np.broadcast_to(np.arange(t, dtype=np.int32) % n_nodes, trace.shape)
    elif mode == "hash":
        assign = sketch._mix32(trace.astype(np.uint32) + salt) % np.uint32(n_nodes)
    else:
        block = (np.arange(t, dtype=np.int32) // session_len).astype(np.uint32)
        assign = np.broadcast_to(sketch._mix32(block + salt) % np.uint32(n_nodes), trace.shape)
    return assign.astype(np.int32)


def _route_level_torch(trace: torch.Tensor, n_nodes: int, mode: str, session_len: int, seed: int) -> torch.Tensor:
    t = trace.shape[-1]
    steps = torch.arange(t, dtype=torch.int64, device=trace.device)
    if mode == "round_robin":
        assign = (steps % n_nodes).expand(trace.shape)
    elif mode == "hash":
        assign = sketch._mix32_i64(((trace.to(torch.int64) & _U32) + _salt(seed)) & _U32) % n_nodes
    else:
        block = steps // session_len
        assign = (sketch._mix32_i64((block + _salt(seed)) & _U32) % n_nodes).expand(trace.shape)
    return assign.to(torch.int32)


def route_point(mode: str, obj_id: int, t: int, n_nodes: int, *, session_len: int = 64, seed: int = 0) -> int:
    """One request's node under :func:`route_level` (a host scalar)."""
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    _check_mode(mode, session_len)
    if mode == "round_robin":
        return int(t % n_nodes)
    key = obj_id if mode == "hash" else t // session_len
    # a 1-element array: uint32 wrap-around is silent for arrays, warned for scalars
    return int(sketch._mix32(np.asarray([key], np.uint32) + np.uint32(_salt(seed)))[0] % np.uint32(n_nodes))


def route_device(trace: torch.Tensor, n_edges: int, mode: str = "hash", *, session_len: int = 64,
                 seed: int = 0) -> torch.Tensor:
    """:func:`route` for a trace that lives on the card, without a host round
    trip: hash and sticky use the 32-bit mixer of :func:`route_level`, so the
    partitions are as deterministic and uniform as the host router's but
    differ from them."""
    return route_level(trace, n_edges, mode, session_len=session_len, seed=seed)
