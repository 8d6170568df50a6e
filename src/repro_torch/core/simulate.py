"""The paper's grid (§3) through the cache_sim kernel.

Each case's 12 Zipf(1.1) traces (the reference's seeds) go through one policy
in one kernel launch, with the policy's default options (wlfu: a window of
10,000 requests, the reference policies' default; tinylfu: no doorkeeper).
CHR, evictions and metadata entries come from the kernel's outputs by the
reference simulator's rules:

* inserts: the kernel's count (every admitted miss that fits inserts);
* evictions = inserts - final occupancy;
* metadata = occupancy, plus parked ids (freq > 0 and not cached) for
  lfu/plfu/plfua/plfua_dyn/gdsf, plus ids in the window (freq > 0) for wlfu,
  plus the sketch's counters (and doorkeeper bits) for tinylfu/plfua_dyn;
  arc's is its directory (residents and ghosts).

A run may be sized (``sizing="sized"``: objects take the sizes of
``bytes_catalogue``, and gdsf scores by them) or, in addition, held to a
byte budget (``sizing="budget"``: ``bytes_budget`` bytes, and every
byte-capable kind holds bytes, not objects). Both are the byte-capacity
benchmark's (``benchmarks/bytes_bench.py`` in the reference): a lognormal
catalogue of median 64 B with size-popularity correlation 0.5, and a budget
of ``cap`` objects of mean size. Such a run also reports its byte CHR (the
bytes of the requests that hit over the bytes requested).

On the card each case also reports its device seconds (CUDA events around the
launch) and the device energy per request at the card's power limit; on the
CPU those fields are ``None``: not measured.

:func:`run_trace` and :func:`hit_miss_scatter` are the paper's own
measurement: they run one trace through a pure-Python policy object
(:mod:`repro_torch.core.policies`) on the host and time its management loop
in CPU seconds (``time.process_time``), the metric the paper converts to
Joules (:func:`repro_torch.core.energy.mgmt_energy_j`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Literal, Sequence

import numpy as np
import torch

from repro_torch._device import card_info, resolve_device
from repro_torch.core import energy, policies, sketch, zipf
from repro_torch.kernels.cache_sim import ops
from repro_torch.workloads import generators

#: the grid's wlfu window: ``policies.make_policy``'s default in the reference
WLFU_WINDOW = 10_000
#: a run's sizes: none (unit), the catalogue's, or the catalogue's under the byte budget
Sizing = Literal[None, "sized", "budget"]


def bytes_catalogue(n_objects: int) -> np.ndarray:
    """The byte-capacity benchmark's size catalogue: lognormal sizes of median
    64 B, size-popularity correlation 0.5, seed 11."""
    return generators.object_sizes(n_objects, dist="lognormal", corr=0.5, seed=11, median=64)


def bytes_budget(sizes: np.ndarray, capacity: int) -> int:
    """The byte-capacity benchmark's budget: ``capacity`` objects of mean size."""
    return int(capacity * sizes.mean())


@dataclasses.dataclass
class CaseResult:
    """Means over the case's samples (the paper reports means of 12)."""

    policy: str
    case: zipf.GridCase
    mean_chr: float
    std_chr: float
    mean_evictions: float
    mean_metadata: float
    mean_byte_chr: float | None  # None for a run without sizes
    device_s: float | None  # device time of the case's ops.cache_sim call; None = not measured
    j_per_request: float | None  # device_s at the power limit per request; None = not measured


def run_case(
    policy: str,
    case: zipf.GridCase,
    n_samples: int = zipf.PAPER_NUM_SAMPLES,
    trace_len: int = zipf.PAPER_TRACE_LEN,
    seed: int = 0,
    device=None,
    power_w: float | None = None,
    sizing: Sizing = None,
) -> CaseResult:
    """One case: ``n_samples`` traces through ``policy`` in one launch.
    ``power_w`` is the card's power limit (read from ``nvidia-smi`` when
    ``None`` on the card); ``sizing`` is as in the module's docstring."""
    dev = resolve_device(device)
    traces_np = zipf.sample_traces(case.n_objects, n_samples, trace_len, seed=seed)
    traces = torch.as_tensor(traces_np, device=dev)
    kw = dict(kind=policy, n_objects=case.n_objects, capacity=case.cache_size, device=dev)
    if policy == "wlfu":
        kw["window"] = WLFU_WINDOW
    if sizing not in (None, "sized", "budget"):
        raise ValueError(f"sizing must be None, 'sized' or 'budget', got {sizing!r}")
    sizes = None if sizing is None else bytes_catalogue(case.n_objects)
    if sizing == "budget":
        kw["capacity_bytes"] = bytes_budget(sizes, case.cache_size)
    if sizes is not None:
        kw["sizes"] = torch.as_tensor(sizes, device=dev)
    if dev.type == "cuda":
        if power_w is None:
            power_w = card_info(dev.index).power_limit_w
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = ops.cache_sim_outputs(traces, **kw)
        end.record()
        torch.cuda.synchronize(dev)
        device_s = start.elapsed_time(end) / 1e3
        j_per_request = energy.device_energy_j(device_s, power_w) / traces.numel()
    else:
        outs = ops.cache_sim_outputs(traces, **kw)
        device_s = j_per_request = None

    hits, freq, in_cache = (outs[k] for k in ("hits", "freq", "in_cache"))
    hits = hits.cpu().numpy().astype(np.int64)
    count = in_cache.sum(dim=1).cpu().numpy()
    metadata = count.copy()
    if policy == "arc":
        metadata = outs["dir_size"].cpu().numpy()
    elif policy == "wlfu":
        metadata += (freq > 0).sum(dim=1).cpu().numpy()
    elif policy not in ("lru", "tinylfu"):
        metadata += ((freq > 0) & ~in_cache).sum(dim=1).cpu().numpy()
    if policy in ("tinylfu", "plfua_dyn"):
        metadata += sketch.DEPTH * sketch.default_width(case.cache_size)
    chrs = hits / trace_len
    mean_byte_chr = None
    if "hit_bytes" in outs and sizes is not None:
        requested = sizes[traces_np].sum(axis=1, dtype=np.int64)
        mean_byte_chr = float(np.mean(outs["hit_bytes"].cpu().numpy() / requested))
    return CaseResult(
        policy=policy,
        case=case,
        mean_chr=float(np.mean(chrs)),
        std_chr=float(np.std(chrs)),
        mean_evictions=float(np.mean(outs["inserts"].cpu().numpy() - count)),
        mean_metadata=float(np.mean(metadata)),
        mean_byte_chr=mean_byte_chr,
        device_s=device_s,
        j_per_request=j_per_request,
    )


def run_grid(
    policy: str,
    cases: Sequence[zipf.GridCase] | None = None,
    n_samples: int = zipf.PAPER_NUM_SAMPLES,
    trace_len: int = zipf.PAPER_TRACE_LEN,
    seed: int = 0,
    device=None,
    sizing: Sizing = None,
) -> list[CaseResult]:
    """The paper's 60-case grid (or a caller-supplied reduction), one launch
    per case, optionally sized and under a byte budget (see :func:`run_case`)."""
    dev = resolve_device(device)
    if cases is None:
        cases = zipf.paper_grid()
    power_w = card_info(dev.index).power_limit_w if dev.type == "cuda" else None
    return [
        run_case(policy, c, n_samples=n_samples, trace_len=trace_len, seed=seed, device=dev, power_w=power_w,
                 sizing=sizing)
        for c in cases
    ]


@dataclasses.dataclass
class SimResult:
    """One trace through one pure-Python policy, with its loop's CPU and wall time."""

    policy: str
    n_objects: int
    capacity: int
    chr: float
    hits: int
    misses: int
    evictions: int
    cpu_time_s: float
    wall_time_s: float
    metadata_entries: int


def run_trace(policy: policies.CachePolicy, trace: Sequence[int] | np.ndarray) -> SimResult:
    """Run ``trace`` through ``policy``, timing the management loop only: the
    trace becomes a Python list first, so decoding it is not timed."""
    if isinstance(trace, np.ndarray):
        trace = trace.tolist()
    c0, w0 = time.process_time(), time.perf_counter()
    policy.run(trace)
    c1, w1 = time.process_time(), time.perf_counter()
    return SimResult(
        policy=policy.name,
        n_objects=-1,
        capacity=policy.capacity,
        chr=policy.chr,
        hits=policy.hits,
        misses=policy.misses,
        evictions=policy.evictions,
        cpu_time_s=c1 - c0,
        wall_time_s=w1 - w0,
        metadata_entries=policy.metadata_entries,
    )


def hit_miss_scatter(policy: policies.CachePolicy, trace: np.ndarray, n_objects: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-object (hits, misses) counts: the data of the paper's Fig. 2
    rank-order scatter."""
    hits = np.zeros(n_objects, dtype=np.int64)
    misses = np.zeros(n_objects, dtype=np.int64)
    for x in trace.tolist():
        if policy.request(x):
            hits[x] += 1
        else:
            misses[x] += 1
    return hits, misses
