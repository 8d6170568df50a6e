"""Single source of truth for policy names across the tiers.

A copy of the reference package's registry, so the port imports nothing of
it: the canonical policy list plus per-tier support flags. Every other module
derives its tuple of names from :func:`names`. The flags describe the
reference package's tiers; which kinds the port's kernel covers is stated by
``repro_torch.kernels.cache_sim.cache_sim.KERNEL_KINDS``.

Deliberately dependency-free, so any module can import it without cycles.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "PolicyInfo",
    "POLICIES",
    "names",
    "info",
    "GDSF_SHIFT",
    "DEFAULT_MAX_VICTIMS",
]

#: fixed-point scale of the GDSF priority H = L + (freq << GDSF_SHIFT) // size
#: — integer arithmetic keeps every tier bit-identical.
GDSF_SHIFT = 8

#: byte-capacity eviction bound when ``max_victims`` is 0: at most this many
#: victims per insertion.
DEFAULT_MAX_VICTIMS = 8


@dataclasses.dataclass(frozen=True)
class PolicyInfo:
    """One policy's identity and which tiers implement it."""

    name: str
    reference: bool  # pure-Python implementation
    jax: bool  # kind accepted by the jitted simulator (and the cdn hierarchy)
    pallas: bool  # kind accepted by the cache_sim kernel
    sketch: bool = False  # carries count-min-sketch state
    #: kind runs under fleet cross-tier placement gating (the ``fill`` gate
    #: of the step)
    placement: bool = True
    #: kind emits the in-scan windowed telemetry series
    telemetry: bool = True
    #: kind supports the group-segmented telemetry axis
    grouped_telemetry: bool = True
    #: eviction *score* consults the per-object size (GDSF family). Every
    #: kind runs under byte-capacity tiers; this flag marks the kinds whose
    #: victim choice itself is size-weighted.
    size_aware: bool = False
    description: str = ""
    #: tunable knobs the PolicySpec/kernel accept for this kind
    options: tuple[str, ...] = ()


POLICIES: tuple[PolicyInfo, ...] = (
    PolicyInfo("lru", True, True, True, description="recency eviction"),
    PolicyInfo("lfu", True, True, True, description="in-memory LFU; eviction destroys metadata"),
    PolicyInfo("plfu", True, True, True, description="Perfect LFU with parked-list"),
    PolicyInfo("plfua", True, True, True, description="PLFU + static rank-prefix hot-set admission", options=("hot_size",)),
    PolicyInfo("wlfu", True, True, True, description="Window-LFU over the last W requests", options=("window",)),
    PolicyInfo("tinylfu", True, True, True, sketch=True, description="sketch-vs-victim admission over LFU eviction (optional doorkeeper bloom front)", options=("window", "sketch_width", "doorkeeper")),
    PolicyInfo("plfua_dyn", True, True, True, sketch=True, description="PLFUA with sketch-refreshed hot set", options=("hot_size", "refresh", "sketch_width")),
    PolicyInfo("gdsf", True, True, True, size_aware=True, description="GreedyDual-Size-Frequency: score = L + freq/size with a global aging credit L ratcheted to each evicted victim's score", options=("capacity_bytes", "max_victims")),
    PolicyInfo("arc", True, True, True, description="Adaptive Replacement Cache: T1/T2 residents + B1/B2 ghost lists with an adaptive recency/frequency target p (byte-capacity mode unsupported)"),
)

_BY_NAME = {p.name: p for p in POLICIES}


def info(name: str) -> PolicyInfo:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; expected one of {tuple(_BY_NAME)}"
        ) from None


def names(
    *,
    reference: bool | None = None,
    jax: bool | None = None,
    pallas: bool | None = None,
    sketch: bool | None = None,
    telemetry: bool | None = None,
    grouped_telemetry: bool | None = None,
    size_aware: bool | None = None,
) -> tuple[str, ...]:
    """Canonical-order names, filtered by tier support (None = don't care)."""
    out = []
    for p in POLICIES:
        if reference is not None and p.reference != reference:
            continue
        if jax is not None and p.jax != jax:
            continue
        if pallas is not None and p.pallas != pallas:
            continue
        if sketch is not None and p.sketch != sketch:
            continue
        if telemetry is not None and p.telemetry != telemetry:
            continue
        if grouped_telemetry is not None and p.grouped_telemetry != grouped_telemetry:
            continue
        if size_aware is not None and p.size_aware != size_aware:
            continue
        out.append(p.name)
    return tuple(out)
