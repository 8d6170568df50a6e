"""Device trace synthesis: the six workload scenarios generated on the card.

The host generators (:mod:`repro_torch.workloads.generators`) build traces in
numpy and copy them to the card; these build the same scenarios there with
``torch.Generator`` streams, so a fleet's traces never cross the host.

Contract, as the reference package's device generators: ``(n_samples,
trace_len)`` int32 ids in ``[0, n_objects)``, ids being initial-popularity
ranks, and the scenarios' distributions. The streams are not the host's, nor
the reference's (``jax.random``'s threefry bits cannot be drawn from a
``torch.Generator``, and CUDA's Philox stream differs from the CPU's), so a
run checked against an oracle moves its generated trace to the host and feeds
it there.

Sample ``i`` is a pure function of ``(seed, i)``: its generator's seed is
:func:`sample_key`, lowbias32 (:func:`repro_torch.core.sketch._mix32`) over
the two, so ``gen_sample(dspec, sample_key(dspec, i))`` equals row ``i`` of
:func:`make_traces_device` however the samples are batched. A stream chunk's
seed folds the chunk index in as well (:func:`stream_chunk_key`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import sketch, zipf

__all__ = [
    "DEVICE_SCENARIO_NAMES",
    "DeviceTraceSpec",
    "gen_sample",
    "gen_stream_chunk",
    "make_traces_device",
    "object_sizes_device",
    "sample_key",
    "stream_chunk_key",
]

DEVICE_SCENARIO_NAMES = (
    "stationary",
    "churn",
    "flash_crowd",
    "diurnal",
    "multi_tenant",
    "scan",
)

#: recognised per-scenario overrides (the host generators' keywords)
_SCENARIO_OPTS = {
    "stationary": (),
    "churn": ("n_phases", "churn_frac"),
    "flash_crowd": ("n_spikes", "spike_len_frac", "spike_intensity"),
    "diurnal": ("n_cycles", "alpha_swing", "n_chunks"),
    "multi_tenant": ("n_tenants", "weights"),
    "scan": ("n_sweeps", "sweep_len_frac", "sweep_intensity", "scan_lo_frac"),
}

#: the salt of the size catalogue's generator (the reference's fold-in constant)
_SIZES_SALT = 611_953


@dataclasses.dataclass(frozen=True)
class DeviceTraceSpec:
    """A fully resolved device scenario (hashable)."""

    scenario: str
    n_objects: int
    n_samples: int = zipf.PAPER_NUM_SAMPLES
    trace_len: int = zipf.PAPER_TRACE_LEN
    seed: int = 0
    alpha: float = zipf.PAPER_ALPHA
    overrides: tuple[tuple[str, Any], ...] = ()

    def __post_init__(self):
        if self.scenario not in DEVICE_SCENARIO_NAMES:
            raise ValueError(f"unknown device scenario {self.scenario!r}; expected one of {DEVICE_SCENARIO_NAMES}")
        allowed = _SCENARIO_OPTS[self.scenario]
        for k, _ in self.overrides:
            if k not in allowed:
                raise ValueError(f"{self.scenario}: unknown override {k!r}; allowed: {allowed}")

    def opt(self, name: str, default):
        return dict(self.overrides).get(name, default)


def _fold(key: int, data: int) -> int:
    """lowbias32 of ``key`` combined with ``data`` (both taken mod 2**32)."""
    h = np.asarray([(int(key) * 0x9E3779B1 + int(data) + 1) & 0xFFFFFFFF], np.uint32)
    return int(sketch._mix32(h)[0])


def sample_key(dspec: DeviceTraceSpec, sample: int) -> int:
    """Generator seed of sample ``sample``: a pure function of (seed, sample)."""
    return _fold(_fold(0, dspec.seed), sample)


def stream_chunk_key(dspec: DeviceTraceSpec, sample: int, chunk: int) -> int:
    """Generator seed of chunk ``chunk`` of sample ``sample``'s unbounded stream."""
    return _fold(sample_key(dspec, sample), chunk)


def _generator(key: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key)


@functools.lru_cache(maxsize=128)
def _cdf(n_objects: int, alpha: float, device: torch.device) -> torch.Tensor:
    """Zipf CDF, accumulated in float64 on the host, float32 on ``device``."""
    return torch.as_tensor(np.cumsum(zipf.zipf_probs(n_objects, alpha)), dtype=torch.float32, device=device)


def _ranks(cdf: torch.Tensor, u: torch.Tensor, n_objects: int) -> torch.Tensor:
    # cumsum rounding can leave the CDF's last entry under 1.0
    return torch.searchsorted(cdf, u, right=True).clamp(max=n_objects - 1).to(torch.int32)


def _uniform(g: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand(n, generator=g, device=g.device)


def _randint(g: torch.Generator, lo: int, hi: int) -> torch.Tensor:
    return torch.randint(lo, hi, (), generator=g, device=g.device)


# ------------------------------------------------------------ per-scenario
def _stationary(dspec: DeviceTraceSpec, g: torch.Generator) -> torch.Tensor:
    n = dspec.n_objects
    return _ranks(_cdf(n, dspec.alpha, g.device), _uniform(g, dspec.trace_len), n)


def _churn(dspec: DeviceTraceSpec, g: torch.Generator) -> torch.Tensor:
    n, t = dspec.n_objects, dspec.trace_len
    n_phases = int(dspec.opt("n_phases", 5))
    churn_frac = float(dspec.opt("churn_frac", 0.3))
    if not 0.0 <= churn_frac <= 1.0:
        raise ValueError(f"churn_frac must be in [0, 1], got {churn_frac}")
    phase_len = max(1, -(-t // max(1, n_phases)))
    phases = -(-t // phase_len)  # phases that occur in the trace
    k = int(round(churn_frac * n))
    ranks = _ranks(_cdf(n, dspec.alpha, g.device), _uniform(g, t), n)
    perm = torch.arange(n, dtype=torch.int32, device=g.device)
    perms = [perm]
    for _ in range(1, phases):
        if k >= 2:
            # k ids swap their popularity ranks among themselves
            moved = torch.randperm(n, generator=g, device=g.device)[:k]
            shuffled = moved[torch.randperm(k, generator=g, device=g.device)]
            perm = perm.clone()
            perm[moved] = perms[-1][shuffled]
        perms.append(perm)
    table = torch.stack(perms)  # (phases, n): rank -> id per phase
    phase_of_t = (torch.arange(t, device=g.device) // phase_len).clamp(max=phases - 1)
    return table[phase_of_t, ranks.long()]


def _flash_crowd(dspec: DeviceTraceSpec, g: torch.Generator) -> torch.Tensor:
    n, t = dspec.n_objects, dspec.trace_len
    n_spikes = int(dspec.opt("n_spikes", 3))
    spike_len = max(1, int(round(float(dspec.opt("spike_len_frac", 0.05)) * t)))
    intensity = float(dspec.opt("spike_intensity", 0.6))
    cold_lo = max(1, (3 * n) // 4)
    out = _ranks(_cdf(n, dspec.alpha, g.device), _uniform(g, t), n)
    pos = torch.arange(t, device=g.device)
    for _ in range(n_spikes):
        # spikes draw their starts independently (the host samples them without
        # replacement; for n_spikes << T an overlap is unlikely)
        start = _randint(g, 0, max(1, t - spike_len))
        hot_id = _randint(g, cold_lo, n).to(torch.int32)
        take = _uniform(g, t) < intensity
        in_window = (pos >= start) & (pos < start + spike_len)
        out = torch.where(in_window & take, hot_id, out)
    return out


def _diurnal(dspec: DeviceTraceSpec, g: torch.Generator) -> torch.Tensor:
    n, t = dspec.n_objects, dspec.trace_len
    n_cycles = int(dspec.opt("n_cycles", 2))
    swing = float(dspec.opt("alpha_swing", 0.5))
    n_chunks = int(dspec.opt("n_chunks", 48))
    bounds = np.linspace(0, t, n_chunks + 1).astype(int)
    mid = 0.5 * (bounds[:-1] + bounds[1:]) / t
    alphas = np.maximum(dspec.alpha + swing * np.sin(2 * np.pi * n_cycles * mid), 0.05)
    pieces = [
        _ranks(_cdf(n, float(a), g.device), _uniform(g, int(hi - lo)), n)
        for a, lo, hi in zip(alphas, bounds[:-1], bounds[1:])
        if hi > lo
    ]
    return torch.cat(pieces)


def _multi_tenant(dspec: DeviceTraceSpec, g: torch.Generator) -> torch.Tensor:
    n, t = dspec.n_objects, dspec.trace_len
    n_tenants = int(dspec.opt("n_tenants", 4))
    weights = dspec.opt("weights", None)
    if n_tenants < 1 or n_tenants > n:
        raise ValueError(f"need 1 <= n_tenants <= n_objects, got {n_tenants}")
    if weights is None:
        w = zipf.zipf_probs(n_tenants, 1.0)
    else:
        if len(weights) != n_tenants:
            raise ValueError("len(weights) must equal n_tenants")
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
    block = n // n_tenants
    sizes = np.full(n_tenants, block, np.int64)
    sizes[: n - block * n_tenants] += 1
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    cum_w = torch.as_tensor(np.cumsum(w), dtype=torch.float32, device=g.device)
    tenant = torch.searchsorted(cum_w, _uniform(g, t), right=True).clamp(max=n_tenants - 1)
    u = _uniform(g, t)
    out = torch.zeros(t, dtype=torch.int32, device=g.device)
    for ti in range(n_tenants):
        idx = _ranks(_cdf(int(sizes[ti]), dspec.alpha, g.device), u, int(sizes[ti]))
        out = torch.where(tenant == ti, int(offsets[ti]) + idx, out)
    return out


def _scan(dspec: DeviceTraceSpec, g: torch.Generator) -> torch.Tensor:
    n, t = dspec.n_objects, dspec.trace_len
    n_sweeps = int(dspec.opt("n_sweeps", 4))
    sweep_len = max(1, int(round(float(dspec.opt("sweep_len_frac", 0.05)) * t)))
    intensity = float(dspec.opt("sweep_intensity", 0.8))
    scan_lo_frac = float(dspec.opt("scan_lo_frac", 0.5))
    if n_sweeps < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")
    if not 0.0 <= intensity <= 1.0:
        raise ValueError(f"sweep_intensity must be in [0, 1], got {intensity}")
    if not 0.0 <= scan_lo_frac < 1.0:
        raise ValueError(f"scan_lo_frac must be in [0, 1), got {scan_lo_frac}")
    base = _ranks(_cdf(n, dspec.alpha, g.device), _uniform(g, t), n)
    if n_sweeps == 0:
        return base
    scan_lo = int(round(scan_lo_frac * n))
    span = n - scan_lo
    # the sweep windows are placed deterministically, as the host's
    in_sweep = np.zeros(t, bool)
    seg = t // n_sweeps
    for i in range(n_sweeps):
        start = i * seg + max(0, (seg - sweep_len) // 2)
        in_sweep[start : start + sweep_len] = True
    take = torch.as_tensor(in_sweep, device=g.device) & (_uniform(g, t) < intensity)
    offset = _randint(g, 0, span)
    k = torch.cumsum(take.to(torch.int32), dim=0) - 1  # walk position of each swept slot
    ids = (scan_lo + (offset + k) % span).to(torch.int32)
    return torch.where(take, ids, base)


_GENERATORS = {
    "stationary": _stationary,
    "churn": _churn,
    "flash_crowd": _flash_crowd,
    "diurnal": _diurnal,
    "multi_tenant": _multi_tenant,
    "scan": _scan,
}


def object_sizes_device(
    n_objects: int,
    *,
    dist: str = "lognormal",
    corr: float = 0.0,
    seed: int = 0,
    median: int = 64,
    sigma: float = 1.2,
    shape: float = 1.5,
    max_size: int = 1 << 20,
    device=None,
) -> torch.Tensor:
    """The size catalogue (:func:`repro_torch.workloads.generators.object_sizes`)
    drawn on the card: ``(n_objects,)`` int32 sizes in ``[1, max_size]``,
    ``corr`` the size-popularity rank-correlation strength; matched in
    distribution to the reference's device catalogue, not in bits."""
    if dist not in ("lognormal", "pareto"):
        raise ValueError(f"unknown size dist {dist!r}; expected lognormal|pareto")
    if not -1.0 <= corr <= 1.0:
        raise ValueError(f"corr must be in [-1, 1], got {corr}")
    dev = resolve_device(device)
    g = _generator(_fold(_fold(0, seed), _SIZES_SALT), dev)
    if dist == "lognormal":
        raw = median * torch.exp(sigma * torch.randn(n_objects, generator=g, device=dev))
    else:
        # a Pareto(shape) draw on [1, inf) is exp(Exponential(1) / shape)
        pareto = torch.exp(torch.empty(n_objects, device=dev).exponential_(generator=g) / shape)
        raw = median * (1.0 + pareto) / (2.0 ** (1.0 / shape))
    raw = torch.clamp(torch.round(raw), 1, max_size).to(torch.int32)
    if corr:
        ids = torch.arange(n_objects, dtype=torch.float32, device=dev)
        keyv = corr * ids / max(1, n_objects - 1) + (1.0 - abs(corr)) * _uniform(g, n_objects)
        order = torch.argsort(keyv, stable=True)  # ascending key gets the largest size
        out = torch.empty_like(raw)
        out[order] = torch.sort(raw, descending=True).values
        raw = out
    return raw


def gen_sample(dspec: DeviceTraceSpec, key: int, device=None) -> torch.Tensor:
    """One ``(trace_len,)`` int32 sample from its generator seed ``key``."""
    g = _generator(key, resolve_device(device))
    return _GENERATORS[dspec.scenario](dspec, g).to(torch.int32)


def make_traces_device(dspec: DeviceTraceSpec, device=None) -> torch.Tensor:
    """All samples: ``(n_samples, trace_len)`` int32 on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    return torch.stack([gen_sample(dspec, sample_key(dspec, i), dev) for i in range(dspec.n_samples)])


def gen_stream_chunk(dspec: DeviceTraceSpec, sample: int, chunk: int, device=None) -> torch.Tensor:
    """One ``(trace_len,)`` int32 chunk of sample ``sample``'s unbounded stream:
    ``dspec.trace_len`` is the chunk's length, and the scenario's time
    structure (churn phases, spikes, cycles, sweeps) unrolls within each
    chunk."""
    return gen_sample(dspec, stream_chunk_key(dspec, sample, chunk), device)
