#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 0]

The kernel ``cache_sim`` has seven programs, entry points of six CUDA
sources: ``cache_sim`` (lru, lfu, plfu, plfua), ``cache_sim/wlfu``,
``cache_sim/tinylfu`` (with or without the doorkeeper),
``cache_sim/plfua_dyn``, ``cache_sim/sized`` (gdsf, and lru/lfu/plfu/plfua/
gdsf under a byte budget), ``cache_sim/plfua_dyn_bytes`` (plfua_dyn under a
byte budget, from ``plfua_dyn.cu``) and ``cache_sim/arc``. Phases, one line
each (or one line per item):

1. device  — the card's name and count, and ``nvidia-smi``'s name and power limit.
2. build   — nvcc builds the six sources from ``src/repro_torch/.../csrc``,
             one process each, all started together; prints ptxas's register
             and shared-memory report for each kernel.
3. check   — each program against its plain PyTorch version, exact on hits,
             freq, in_cache, inserts and (sized runs) hit bytes, at S = 12:
             lru/lfu/plfu/plfua at T = 10,000 and (N, cap) = (100, 2),
             (10,000, 200), (46,416, 4,225), (100,000, 2,000); wlfu, tinylfu
             without and with the doorkeeper, and plfua_dyn at (10,000, 200,
             20,500), (100,000, 2,000, 20,000) and a small case with explicit
             window, sketch width, refresh and hot-set size; gdsf with the
             lognormal catalogue, and lru/lfu/plfu/plfua/gdsf/plfua_dyn under a byte
             budget with the lognormal and the pareto catalogue, at (10,000,
             200) and (100,000, 2,000), T = 20,000; a max_victims=2 case whose
             bound is hit; arc at (100, 2), (10,000, 200), (100,000, 2,000) on
             Zipf and scan traces, its directory size included. With unit
             sizes and capacity_bytes == capacity each byte program must give
             the object-count program's outputs. The plain version runs on the
             card for N > 10,000 and in CPU worker processes, overlapping the
             card's work, for N <= 10,000.
4. grid    — ``simulate.run_grid``: the paper's 60 cases x 12 samples x 100,000
             requests for the seven object-count kinds, gdsf with the
             byte-capacity catalogue, arc, and gdsf under the byte budget, and
             the N = 100,000 row under the byte budget for lru/lfu/plfu/plfua/
             plfua_dyn, with every program's launch count set to 0 just before
             and read just after; the smallest case of each full-grid row is
             held to the same case run by the plain version on the CPU, and
             plfu's CHR must beat lfu's.
5. scan    — lru, lfu, arc and tinylfu (doorkeeper 256) on ``scan`` traces and
             their stationary base (N = 6,000, cap = 300, 8 x 50,000, seed 33,
             6 sweeps of 6 %): each CHR and the scan cost; arc must beat lru
             and lfu on scan, as the JAX reference does at this setting.
   profile — ``telemetry.timing.measure`` over plfua's grid row with
             ``profile_dir``: the device's idle share between launches, from the
             ``torch.profiler`` trace and from CUDA events.
6. measure — each program at N = 100,000, cap = 2,000, S = 12, T = 100,000
             (``cache_sim`` through lfu, ``cache_sim/sized`` through gdsf and
             both byte programs under the byte budget of 2,000 objects of mean
             size): the kernel's time from CUDA events after a warm-up, the
             plain version's time once at T = 20,000 (the kernel is held to it
             there), and the least time the card could take (bound: the bytes
             moved, or the operations the function needs, see ``bound``).
7. telemetry — each program's two telemetry instances (``+telemetry`` and
             ``+telemetry_grouped``, W = T // 16, 4 tenant groups): checks,
             exact against the plain version, ungrouped on Zipf and grouped on
             ``multi_tenant`` traces, at (10,000, 200) with T = 10,000 (plain
             in the CPU workers, started with phase 3), at (100,000, 2,000) with
             T = 5,000 (plain on the card), and W = 1 and W > T at (130, 3),
             T = 2,010 (a partial plfua_dyn period); then the telemetry path at
             the measured case (T = 100,000) through ``ops.cache_sim_outputs``,
             with the launch counts set to 0 just before and read just after:
             primary outputs equal the instance without telemetry's, the hits
             column sums to the hit count, requests equal the window sizes, and
             the grouped series summed over the groups equals the ungrouped;
             then, on the multi_tenant traces, each instance's time between
             two telemetry-off times (in turns: off, ungrouped, grouped, off)
             and its ratio to their mean (on/off).
8. kernels — one JSON line, an entry per kernel instance, with the trace
             lengths of the kernel's time (``T``) and the plain version's
             (``plain_T``).

The last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before it; without a card the script exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch._device import card_info  # noqa: E402
from repro_torch.core import simulate, sketch, zipf  # noqa: E402
from repro_torch.kernels.cache_sim import cache_sim as kernel  # noqa: E402
from repro_torch.kernels.cache_sim import ops  # noqa: E402
from repro_torch.telemetry import spec as telemetry_spec  # noqa: E402
from repro_torch.telemetry import timing  # noqa: E402
from repro_torch.workloads import generators  # noqa: E402

BASE_KINDS = ("lru", "lfu", "plfu", "plfua")
ADMISSION_KINDS = ("wlfu", "tinylfu", "plfua_dyn")
KINDS = BASE_KINDS + ADMISSION_KINDS
BYTE_KINDS = kernel.BYTE_CAPABLE_KINDS
SAMPLES = 12
# the base program's check, cut from T = 20,000 to 10,000 to make room for the
# other programs' checks within the script's time
BASE_CHECK_CASES = ((100, 2), (10_000, 200), (46_416, 4_225), (100_000, 2_000))
BASE_CHECK_LEN = 10_000
# (N, cap, T, explicit options): the admission programs' checks
ADMISSION_CHECK_CASES = (
    (10_000, 200, 20_500, {}),
    (100_000, 2_000, 20_000, {}),
    (130, 3, 2_000, dict(window=33, refresh=50, sketch_width=96, hot_size=7)),
)
SIZED_CHECK_CASES = ((10_000, 200), (100_000, 2_000))
SIZED_CHECK_LEN = 20_000
ARC_CHECK_CASES = ((100, 2), (10_000, 200), (100_000, 2_000))
# the largest N whose plain version runs in a CPU worker, not on the card
CPU_PLAIN_MAX_N = 10_000
CPU_WORKERS = 6
SCAN_KW = dict(n_sweeps=6, sweep_len_frac=0.06)  # benchmarks/scan_bench.py's full setting
SCAN_N, SCAN_CAP, SCAN_SAMPLES, SCAN_LEN, SCAN_SEED = 6_000, 300, 8, 50_000, 33
SCAN_KINDS = (("lru", {}), ("lfu", {}), ("arc", {}), ("tinylfu", dict(doorkeeper=256)))
MEASURE_N, MEASURE_CAP, MEASURE_LEN, PLAIN_MEASURE_LEN = 100_000, 2_000, 100_000, 20_000
# the kind (and whether under the byte budget) each program is measured through
MEASURED = {"cache_sim": ("lfu", False), "cache_sim/wlfu": ("wlfu", False),
            "cache_sim/tinylfu": ("tinylfu", False), "cache_sim/plfua_dyn": ("plfua_dyn", False),
            "cache_sim/sized": ("gdsf", True), "cache_sim/plfua_dyn_bytes": ("plfua_dyn", True),
            "cache_sim/arc": ("arc", False)}
SOURCE_DIR = "src/repro_torch/kernels/cache_sim/csrc"
TPU_KERNEL = "src/repro/kernels/cache_sim/cache_sim.py"
REPLACES = {  # the TPU kernel's program each one replaces
    "cache_sim": f"{TPU_KERNEL}:187",  # _cache_sim_kernel (base_step, l.320)
    "cache_sim/wlfu": f"{TPU_KERNEL}:465",  # wlfu_step
    "cache_sim/tinylfu": f"{TPU_KERNEL}:499",  # tinylfu_step (+ sketch primitives, l.105-151)
    "cache_sim/plfua_dyn": f"{TPU_KERNEL}:154",  # _refresh_hot (+ the chunked loop, l.665)
    "cache_sim/sized": f"{TPU_KERNEL}:359",  # base_step's evict_body and gdsf score (l.359-425)
    "cache_sim/plfua_dyn_bytes": f"{TPU_KERNEL}:359",  # evict_body in plfua_dyn's chunked walk
    "cache_sim/arc": f"{TPU_KERNEL}:570",  # arc_step
}
#: H100 SXM HBM3 rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: INT32 lanes per Hopper SM: 4 partitions x 16 (the Hopper architecture white paper)
INT32_LANES_PER_SM = 64
#: the row options of the grid: the byte-capacity catalogue, and its budget
SIZED = dict(sizing="sized")
BUDGET = dict(sizing="budget")
#: telemetry: W = T // 16 (the reference's telemetry bench), 4 tenant groups on multi_tenant traces
TEL_WINDOWS, TEL_GROUPS = 16, 4
#: (N, cap, T) of the telemetry checks: the small one's plain runs in the CPU workers, the large
#: one's on the card; both cut from T = 20,000 to stay in the script's time
TEL_CHECK_CASES = ((10_000, 200, 10_000), (100_000, 2_000, 5_000))
#: (N, cap, T, options): the window edges W = 1 and W > T, T not a multiple of plfua_dyn's refresh
TEL_EDGE_CASE = (130, 3, 2_010, dict(window=33, refresh=50, sketch_width=96, hot_size=7))
#: what each telemetry instance replaces: tel_update, and plfua_dyn's refresh/churn rows
TEL_REPLACES = {program: f"{TPU_KERNEL}:238" for program in MEASURED}
TEL_REPLACES.update({"cache_sim/plfua_dyn": f"{TPU_KERNEL}:688", "cache_sim/plfua_dyn_bytes": f"{TPU_KERNEL}:688"})
#: the options of a call that are not PolicySpec fields
CALL_OPTIONS = ("sizes", "telemetry_window", "n_groups", "groups")
#: the grid row profiled for the device's idle share
PROFILED_ROW = "plfua"


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def max_abs_err(got: dict, want: dict) -> int:
    """Largest difference over the outputs both have (argmins is the kernel's only)."""
    require(set(want) <= set(got) and set(kernel.OUTPUTS) <= set(want),
            f"the kernel's outputs {sorted(got)} do not cover the plain version's {sorted(want)}")
    err = 0
    for k, b in want.items():
        a = torch.as_tensor(got[k]).cpu().to(torch.int64)
        b = torch.as_tensor(b).cpu().to(torch.int64)
        require(a.shape == b.shape, f"{k}: shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a - b).abs().max()))
    return err


def cuda_ms(fn):
    """(result, device ms) of one call, bracketed by CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def grid_options(kind: str) -> dict:
    """The options ``simulate.run_case`` gives a kind."""
    return dict(window=simulate.WLFU_WINDOW) if kind == "wlfu" else {}


def catalogue(dist: str, n: int) -> np.ndarray:
    """The byte-capacity benchmark's catalogue of ``dist``."""
    return generators.object_sizes(n, dist=dist, corr=0.5, seed=11, median=64)


def option_text(spec, sizes_dist: str | None = None) -> str:
    """The options a kind runs with, after the defaults are filled in."""
    kind, opts = spec.kind, {}
    if kind in ("plfua", "plfua_dyn"):
        opts["hot_size"] = spec.effective_hot
    if kind in ("wlfu", "tinylfu"):
        opts["window"] = spec.effective_window
    if kind == "plfua_dyn":
        opts["refresh"] = spec.effective_refresh
    if kind in ("tinylfu", "plfua_dyn"):
        opts["sketch_width"] = spec.effective_sketch_width
    if spec.doorkeeper:
        opts["doorkeeper"] = spec.doorkeeper
    if spec.capacity_bytes:
        opts.update(capacity_bytes=spec.capacity_bytes, max_victims=spec.effective_max_victims)
    if sizes_dist:
        opts["sizes"] = sizes_dist
    return json.dumps(opts)


# ------------------------------------------------------------------ CPU workers
def _worker_init() -> None:
    torch.set_num_threads(1)


def cpu_plain(traces: np.ndarray, kw: dict) -> dict:
    """The plain version on the CPU (a worker process): numpy outputs."""
    outs = kernel.cache_sim_plain(torch.as_tensor(traces), **kw)
    return {k: v.numpy() for k, v in outs.items()}


def cpu_grid_case(kind: str, options: str, seed: int) -> tuple:
    """The smallest grid case of a row through the plain version on the CPU."""
    kw = {"": {}, "sized": SIZED, "bytes": BUDGET}[options]
    r = simulate.run_case(kind, zipf.paper_grid()[0], seed=seed, device="cpu", **kw)
    return (r.mean_chr, r.std_chr, r.mean_evictions, r.mean_metadata, r.mean_byte_chr)


class Checks:
    """Kernel runs on the card, each held to the plain version: on the card
    at once, or in a CPU worker (small N) and compared when it comes back."""

    def __init__(self, pool, seed: int):
        self.pool, self.seed = pool, seed
        self.worst = dict.fromkeys(kernel.INSTANCES, 0)
        self.pending = []
        self.count = 0
        self.plain_ms = {}  # instance -> (ms, T) of its last plain run on the card

    def run(self, label: str, kind: str, n: int, cap: int, trace_len: int, traces=None, sizes_dist=None,
            budget: bool = False, **kw) -> dict:
        """One check; returns the kernel's outputs."""
        t1 = time.perf_counter()
        if traces is None:
            traces = zipf.sample_traces(n, SAMPLES, trace_len, seed=self.seed)
        if sizes_dist:
            sizes = catalogue(sizes_dist, n)
            kw["sizes"] = sizes
            if budget:
                kw["capacity_bytes"] = simulate.bytes_budget(sizes, cap)
        kw.update(kind=kind, n_objects=n, capacity=cap)
        spec = kernel.spec_of(**{k: v for k, v in kw.items() if k not in CALL_OPTIONS})
        program = kernel.instance_of(kernel.program_of(kind, spec.capacity_bytes), kw.get("telemetry_window", 0),
                                     kw.get("n_groups", 0))
        got = kernel.cache_sim_cuda(torch.as_tensor(traces, device="cuda"), **kw)
        torch.cuda.synchronize()
        got = {k: v.cpu() for k, v in got.items()}
        line = (f"[check {label}] program={program} n_objects={n} capacity={cap} T={trace_len} "
                f"options={option_text(spec, sizes_dist)} hits={int(got['hits'].sum())} "
                f"inserts={int(got['inserts'].sum())}")
        if "argmins" in got:
            line += f" dir_size={got['dir_size'].tolist()} argmins={int(got['argmins'].sum())}"
        if "series" in got:
            line += (f" telemetry_window={kw['telemetry_window']} n_groups={kw.get('n_groups', 0)} "
                     f"series_shape={list(got['series'].shape)}")
        what = f"{label} {program} N={n} cap={cap} T={trace_len} {option_text(spec, sizes_dist)}"
        self.count += 1
        if n <= CPU_PLAIN_MAX_N:
            future = self.pool.submit(cpu_plain, traces, kw)
            self.pending.append((future, got, program, line + " plain=cpu", what, t1))
        else:
            want, ms = cuda_ms(lambda: kernel.cache_sim_plain(torch.as_tensor(traces, device="cuda"), **kw))
            self.plain_ms[program] = (ms, trace_len)
            self.compare(got, want, program, line + f" plain=card plain_ms={ms}", what, t1)
        return got

    def compare(self, got, want, program, line, what, t1) -> None:
        err = max_abs_err(got, want)
        print(f"{line} max_abs_err={err} elapsed_s={time.perf_counter() - t1:.3f}", flush=True)
        require(err == 0, f"kernel != plain version: {what}")
        self.worst[program] = max(self.worst[program], err)

    def finish(self) -> None:
        """Wait for the CPU workers' plain runs and compare them."""
        for future, got, program, line, what, t1 in self.pending:
            self.compare(got, future.result(), program, line, what, t1)
        self.pending = []


def same_outputs(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in kernel.OUTPUTS)


def tel_kinds() -> dict:
    """Each program's kind in the telemetry phase (the measured one) with
    its sizes: the byte programs under the lognormal budget, gdsf's object-
    count program over the lognormal catalogue."""
    return {program: (kind, dict(sizes_dist="lognormal", budget=True) if with_budget else
                      dict(sizes_dist="lognormal") if kind == "gdsf" else {})
            for program, (kind, with_budget) in MEASURED.items()}


def run_telemetry_checks(checks: Checks, seed: int) -> None:
    """Each program's telemetry instances against the plain version: ungrouped
    on Zipf traces, grouped on multi_tenant traces of 4 tenants; at the small
    case also byte mode's multi-victim evictions per group (lru under the
    pareto budget, 2 victims at most) and gdsf's object-count program; and the
    window edges W = 1 (grouped) and W > T."""
    for n, cap, trace_len in TEL_CHECK_CASES:
        w = trace_len // TEL_WINDOWS
        grouped = dict(traces=generators.multi_tenant(n, SAMPLES, trace_len, seed=seed, n_tenants=TEL_GROUPS),
                       telemetry_window=w, n_groups=TEL_GROUPS, groups=generators.tenant_groups(n, TEL_GROUPS))
        for kind, extra in tel_kinds().values():
            extra = {**grid_options(kind), **extra}
            checks.run(f"{kind} telemetry", kind, n, cap, trace_len, telemetry_window=w, **extra)
            checks.run(f"{kind} telemetry grouped", kind, n, cap, trace_len, **grouped, **extra)
        if n <= CPU_PLAIN_MAX_N:
            checks.run("lru+bytes telemetry grouped", "lru", n, cap, trace_len, sizes_dist="pareto", budget=True,
                       max_victims=2, **grouped)
            checks.run("gdsf telemetry grouped", "gdsf", n, cap, trace_len, **grouped)
    n, cap, trace_len, explicit = TEL_EDGE_CASE
    tenants = generators.multi_tenant(n, SAMPLES, trace_len, seed=seed, n_tenants=TEL_GROUPS)
    for kind, extra in tel_kinds().values():
        extra = {**explicit, **extra}
        checks.run(f"{kind} telemetry W=1", kind, n, cap, trace_len, traces=tenants, telemetry_window=1,
                   n_groups=TEL_GROUPS, groups=generators.tenant_groups(n, TEL_GROUPS), **extra)
        checks.run(f"{kind} telemetry W>T", kind, n, cap, trace_len, telemetry_window=trace_len + 7, **extra)


def run_checks(checks: Checks, seed: int) -> None:
    for n, cap in BASE_CHECK_CASES:
        for kind in BASE_KINDS:
            checks.run(kind, kind, n, cap, BASE_CHECK_LEN)
    for n, cap, trace_len, explicit in ADMISSION_CHECK_CASES:
        for kind in ADMISSION_KINDS:
            variants = [{}]
            if kind == "tinylfu":
                variants.append(dict(doorkeeper=sketch.default_doorkeeper(cap)))
            for extra in variants:
                # options a kind does not take are ignored, as the reference does
                checks.run(kind, kind, n, cap, trace_len, **{**grid_options(kind), **explicit, **extra})
    for n, cap in SIZED_CHECK_CASES:
        checks.run("gdsf", "gdsf", n, cap, SIZED_CHECK_LEN, sizes_dist="lognormal")
        for dist in generators.SIZE_DISTS:
            for kind in BYTE_KINDS:
                checks.run(f"{kind}+bytes", kind, n, cap, SIZED_CHECK_LEN, sizes_dist=dist, budget=True)
    # max_victims=2 where the bound is hit: the run differs from the default bound's
    n, cap = SIZED_CHECK_CASES[0]
    traces = zipf.sample_traces(n, SAMPLES, SIZED_CHECK_LEN, seed=seed)
    capped = checks.run("gdsf+bytes", "gdsf", n, cap, SIZED_CHECK_LEN, traces=traces, sizes_dist="pareto",
                        budget=True, max_victims=2)
    sizes = catalogue("pareto", n)
    default = kernel.cache_sim_cuda(
        torch.as_tensor(traces, device="cuda"), kind="gdsf", n_objects=n, capacity=cap, sizes=sizes,
        capacity_bytes=simulate.bytes_budget(sizes, cap))
    require(not same_outputs(capped, default), "max_victims=2 never bound the pareto case")
    print("[check max_victims] gdsf pareto N=10000: max_victims=2 differs from the default bound "
          f"(inserts {int(capped['inserts'].sum())} vs {int(default['inserts'].sum())})")
    # unit sizes with capacity_bytes == capacity: the byte program gives the object-count program's outputs
    dev_traces = torch.as_tensor(traces, device="cuda")
    for kind in BYTE_KINDS:
        kw = dict(kind=kind, n_objects=n, capacity=cap)
        bytes_run = kernel.cache_sim_cuda(dev_traces, capacity_bytes=cap, **kw)
        object_run = kernel.cache_sim_cuda(dev_traces, **kw)
        require(same_outputs(bytes_run, object_run), f"unit sizes: {kind} byte program != object-count program")
        print(f"[check unit-sizes {kind}] {kernel.program_of(kind, cap)} == {kernel.program_of(kind)} "
              f"N={n} cap={cap} T={SIZED_CHECK_LEN} hits={int(bytes_run['hits'].sum())}")
    for n, cap in ARC_CHECK_CASES:
        checks.run("arc", "arc", n, cap, SIZED_CHECK_LEN)
        scan = generators.scan(n, SAMPLES, SIZED_CHECK_LEN, seed=SCAN_SEED, **SCAN_KW)
        checks.run("arc scan", "arc", n, cap, SIZED_CHECK_LEN, traces=scan)


# ------------------------------------------------------------------------ bound
def bound(program: str, got: dict, spec, card, sms: int, n_sizes: int, n_groups_row: int = 0) -> dict:
    """The least time the card could take for the measured call: the larger of
    its bytes (inputs read once, outputs written once) over the HBM rate and
    the operations the function needs, counted from this run's outputs, over
    the INT32 peak. A telemetry instance's series is one of its outputs and
    its group row (``n_groups_row`` ints) one of its inputs.

    The function's need, not the kernel's algorithm: a request costs a hit
    test and an update (2); lru's and arc's lists are recency lists whose LRU
    is a list head, so each list move or LRU lookup costs 1; a keyed kind
    (lfu, plfu, plfua, gdsf, the sketch kinds) keeps its residents in a heap,
    so each re-price on a hit, insert and eviction costs ceil(log2 N); the
    sketch kinds add their DEPTH counters a request, their estimates, and the
    sketch's aging; a byte budget adds a fit test and a ledger update a
    request. ``scan_operations`` is what the kernels' O(N) block argmin does
    instead (N compares per eviction or list-LRU search), kept as a diagnostic."""
    hits, freq, in_cache, inserts = (got[k] for k in kernel.OUTPUTS)
    s, n = freq.shape
    trace_len = MEASURE_LEN
    requests = s * trace_len
    n_hits = int(hits.sum())
    occupancy = int(in_cache.sum())
    evictions = int(inserts.sum()) - occupancy
    n_bytes = (requests * 4 + (n_sizes + n_groups_row) * 4
               + sum(a.numel() * a.element_size() for a in got.values()))
    width = spec.effective_sketch_width
    log_n = math.ceil(math.log2(n))
    heap_ops = n_hits + int(inserts.sum()) + evictions  # re-price, push, pop
    counted = {"hits": n_hits, "evictions": evictions, "log2_n": log_n}
    operations = 2 * requests
    if spec.capacity_bytes:
        operations += 2 * requests  # the fit test and the ledger's update
    if program == "cache_sim/arc":
        argmins = int(got["argmins"].sum())
        operations += requests + argmins  # a list move a request, a list-head lookup per LRU search
        scan_operations = argmins * n
        counted.update(argmins=argmins)
    else:
        operations += heap_ops * log_n
        scan_operations = evictions * n
        if program == "cache_sim/wlfu":
            operations += 2 * requests  # the window's two count updates a step
        if program == "cache_sim/tinylfu":
            # every miss into a full cache duels the heap's top: two estimates
            duels = requests - n_hits - occupancy
            agings = s * (trace_len // spec.effective_window)
            operations += requests * sketch.DEPTH + duels * 2 * sketch.DEPTH + agings * sketch.DEPTH * width
            scan_operations = duels * n
            counted.update(duels=duels, agings=agings)
        if program in ("cache_sim/plfua_dyn", "cache_sim/plfua_dyn_bytes"):
            # a refresh: every id's estimate, a linear-time top-k selection, the rows' halving
            refreshes = s * (trace_len // spec.effective_refresh)
            operations += requests * sketch.DEPTH + refreshes * (n * (sketch.DEPTH + 1) + sketch.DEPTH * width)
            scan_operations += refreshes * n * (sketch.DEPTH + 2 * log_n)  # the kernel's two binary searches
            counted.update(refreshes=refreshes)
    int32_peak = sms * INT32_LANES_PER_SM * card.max_sm_clock_mhz * 1e6
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, operations / int32_peak * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    return dict(bytes=n_bytes, operations=operations, int32_peak_ops_per_s=int32_peak, bytes_ms=bytes_ms,
                operations_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by, scan_operations=scan_operations,
                scan_operations_ms=scan_operations / int32_peak * 1e3, **counted)


def profile_row(seed: int, card) -> None:
    """``measure`` over one grid row (PROFILED_ROW's 60 cases) with a
    ``torch.profiler`` trace: the device's idle share between the first
    kernel's start and the last one's end, from the trace's kernels, and from
    CUDA events (1 - the cases' device seconds over the timed call's)."""
    t0 = time.perf_counter()
    paper = zipf.paper_grid()
    rows = []
    tm = timing.measure(lambda: rows.append(simulate.run_grid(PROFILED_ROW, paper, seed=seed)),
                        steps=len(paper) * zipf.PAPER_NUM_SAMPLES * zipf.PAPER_TRACE_LEN, repeats=1,
                        profile_dir=Path(__file__).resolve().parent / "build" / "profile")
    device_s = sum(r.device_s for r in rows[2])  # the timed call's cases
    trace = tm.trace
    require(trace is not None and trace.path.exists(), "the profiled call wrote no trace")
    print(f"[profile {PROFILED_ROW}] cases={len(paper)} trace={trace.path} trace_kernels={trace.kernels} "
          f"trace_busy_s={trace.busy_s} trace_span_s={trace.span_s} trace_idle_share={trace.idle_share} "
          f"row_s={tm.execute_s} cases_device_s={device_s} events_idle_share={1 - device_s / tm.execute_s} "
          f"card={card.label!r} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)


def run_telemetry(traces, offs: dict, checks: Checks, card, sms: int, seed: int) -> list[dict]:
    """The telemetry path at the measured case: each program's ungrouped
    instance on the Zipf traces (``offs``: the measure phase's outputs
    without telemetry on them) and on multi_tenant traces, and its grouped
    instance on the latter, through ``ops.cache_sim_outputs``, with every
    launch count set to 0 just before and read just after; the identities
    the series must keep; then each instance's time on the multi_tenant
    traces between two telemetry-off times. Returns the ``kernels`` line's
    entries."""
    n, cap, trace_len = MEASURE_N, MEASURE_CAP, MEASURE_LEN
    w = trace_len // TEL_WINDOWS
    tenants = torch.as_tensor(generators.multi_tenant(n, SAMPLES, trace_len, seed=seed, n_tenants=TEL_GROUPS),
                              device="cuda")
    groups = torch.as_tensor(generators.tenant_groups(n, TEL_GROUPS), device="cuda")
    sizes = simulate.bytes_catalogue(n)
    calls = {}
    for program, (kind, with_budget) in MEASURED.items():
        kw = dict(kind=kind, n_objects=n, capacity=cap, **grid_options(kind))
        if with_budget:
            kw.update(capacity_bytes=simulate.bytes_budget(sizes, cap))
        if kernel.spec_of(**kw).size_aware:
            kw["sizes"] = sizes
        calls[program] = kw
    flat = dict(telemetry_window=w)
    grouped = dict(telemetry_window=w, n_groups=TEL_GROUPS, groups=groups)

    t0 = time.perf_counter()
    for instance in kernel.LAUNCHES:
        kernel.LAUNCHES[instance] = 0
    runs = {}
    for program, kw in calls.items():
        runs[program] = (ops.cache_sim_outputs(traces, **kw, **flat),
                         ops.cache_sim_outputs(tenants, **kw, **flat),
                         ops.cache_sim_outputs(tenants, **kw, **grouped))
    torch.cuda.synchronize()
    launches = dict(kernel.LAUNCHES)
    want = {instance: 0 for instance in kernel.LAUNCHES}
    for program in calls:
        want[kernel.instance_of(program, w)] = 2
        want[kernel.instance_of(program, w, TEL_GROUPS)] = 1
    require(launches == want, f"the telemetry path launched {launches}, expected {want}")
    print(f"[telemetry] path launches={json.dumps({k: v for k, v in launches.items() if v})} "
          f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)

    entries = []
    window_sizes = telemetry_spec.window_sizes(trace_len, w, device="cuda")
    for program, kw in calls.items():
        t1 = time.perf_counter()
        zipf_flat, tenant_flat, tenant_grouped = runs[program]
        tenant_off = kernel.cache_sim_cuda(tenants, **kw)
        # the series is observational: the primary outputs are the instance's without telemetry
        require(same_outputs(zipf_flat, offs[program]), f"{program}: telemetry changed the primary outputs")
        require(same_outputs(tenant_flat, tenant_off) and same_outputs(tenant_grouped, tenant_off),
                f"{program}: telemetry changed the primary outputs on multi_tenant traces")
        for run in (zipf_flat, tenant_flat):
            series = run["series"]
            require(tuple(series.shape) == (SAMPLES, len(window_sizes), telemetry_spec.N_METRICS),
                    f"{program}: series shape {tuple(series.shape)}")
            require(torch.equal(series[..., 1].sum(dim=1), run["hits"].long()), f"{program}: hits column != hits")
            require(bool((series[..., 0] == window_sizes).all()), f"{program}: requests != window sizes")
        summed = tenant_grouped["series"].sum(dim=2, dtype=torch.int32)
        require(torch.equal(summed, tenant_flat["series"]), f"{program}: grouped series summed over G != ungrouped")
        occupancy = tenant_grouped["series"][:, -1, :, telemetry_spec.METRIC_INDEX["occupancy"]]
        require(torch.equal(occupancy.sum(dim=1), tenant_off["in_cache"].sum(dim=1, dtype=torch.int32)),
                f"{program}: the last window's occupancy != the final residents")

        def timed(trace_set, **tel):
            tm = timing.measure(kernel.cache_sim_cuda, trace_set, steps=trace_set.numel(), repeats=2, **kw, **tel)
            return tm.execute_s * 1e3, tm.mean_execute_s * 1e3

        spec = kernel.spec_of(**{k: v for k, v in kw.items() if k not in CALL_OPTIONS})
        # in turns on the same traces: off, ungrouped, grouped, off; on/off is against the offs' mean
        off_first, _ = timed(tenants)
        timings = {"flat": timed(tenants, **flat), "grouped": timed(tenants, **grouped)}
        off_last, _ = timed(tenants)
        ref_ms = (off_first + off_last) / 2
        # arc's search count (for its bound) is the kernel's diagnostic, which ops drops: the
        # instance without telemetry made the same searches
        searches = {"argmins": tenant_off["argmins"]} if "argmins" in tenant_off else {}
        line = (f"[telemetry {program}] kind={kw['kind']} N={n} cap={cap} S={SAMPLES} T={trace_len} W={w} "
                f"groups={TEL_GROUPS} traces=multi_tenant off_ms={off_first} off_ms_after={off_last}")
        for instance, layout, run, n_groups_row in (
                (kernel.instance_of(program, w), "flat", tenant_flat, 0),
                (kernel.instance_of(program, w, TEL_GROUPS), "grouped", tenant_grouped, n)):
            ms, mean_ms = timings[layout]
            b = bound(program, {**run, **searches}, spec, card, sms, n if spec.size_aware else 0, n_groups_row)
            plain_ms, plain_t = checks.plain_ms[instance]
            line += (f" | {instance}: ms={ms} mean_ms={mean_ms} on_off={ms / ref_ms} bound_ms={b['bound_ms']} "
                     f"bound_by={b['bound_by']} bytes={b['bytes']} plain_ms={plain_ms} plain_T={plain_t} "
                     f"launches={launches[instance]}")
            entries.append({
                "name": instance, "route": "cuda",
                "source": f"{SOURCE_DIR}/{kernel.PROGRAMS[program].source.name}",
                "replaces": TEL_REPLACES[program], "launches": launches[instance],
                "max_abs_err": checks.worst[instance], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
                "T": trace_len, "plain_T": plain_t,
            })
        print(line + f" card={card.label!r} elapsed_s={time.perf_counter() - t1:.3f}", flush=True)
    return entries


def ptxas_report(lib) -> list[str]:
    """One ``kernel: usage`` item per kernel the library holds."""
    out, name = [], None
    for line in lib.ptxas:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("[device] no CUDA device: chip_smoke.py runs on the card", file=sys.stderr)
        return 1

    # 1. device
    t0 = time.perf_counter()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    card = card_info(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[device] name={name!r} count={count} sms={sms} power_limit_w={card.power_limit_w} "
          f"max_sm_clock_mhz={card.max_sm_clock_mhz} torch={torch.__version__} cuda={torch.version.cuda} "
          f"elapsed_s={time.perf_counter() - t0:.3f}")
    print(smi)

    # the CPU workers: plain runs of the small checks and the grid's CPU references
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(CPU_WORKERS, mp_context=ctx, initializer=_worker_init) as pool:
        # 2. build: one nvcc per source, all started together (programs of one source share its build)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(kernel.PROGRAMS)) as threads:
            built = {lib.path: lib for lib in threads.map(kernel.library, kernel.PROGRAMS)}
        for lib in built.values():
            report = ptxas_report(lib)
            require(bool(report), f"ptxas printed no register report for {lib.path.name}")
            print(f"[build] library={lib.path.name} ptxas={report}")
        print(f"[build] sources={len(built)} programs={len(kernel.PROGRAMS)} "
              f"elapsed_s={time.perf_counter() - t0:.3f}")

        # 3. check: every program == its plain version, exactly
        t0 = time.perf_counter()
        checks = Checks(pool, seed)
        run_checks(checks, seed)
        run_telemetry_checks(checks, seed)
        print(f"[check] card phase done: {checks.count} checks, {len(checks.pending)} plain runs "
              f"still in CPU workers elapsed_s={time.perf_counter() - t0:.3f}", flush=True)

        # 4. grid: the main path, through every program
        t0 = time.perf_counter()
        paper = zipf.paper_grid()
        n100k = [c for c in paper if c.n_objects == 100_000]
        rows = [(kind, kind, {}, "", paper) for kind in KINDS]
        rows += [("gdsf", "gdsf", SIZED, "sized", paper), ("arc", "arc", {}, "", paper),
                 ("gdsf+bytes", "gdsf", BUDGET, "bytes", paper)]
        rows += [(f"{kind}+bytes", kind, BUDGET, "bytes", n100k) for kind in BYTE_KINDS if kind != "gdsf"]
        references = {label: pool.submit(cpu_grid_case, kind, opts, seed)
                      for label, kind, _, opts, cases in rows if cases is paper}
        expected = dict.fromkeys(kernel.LAUNCHES, 0)
        n_requests = len(paper) * zipf.PAPER_NUM_SAMPLES * zipf.PAPER_TRACE_LEN
        grid = {}
        for program in kernel.LAUNCHES:
            kernel.LAUNCHES[program] = 0
        for label, kind, kw, _, cases in rows:
            t1 = time.perf_counter()
            program = kernel.program_of(kind, kw == BUDGET)
            expected[program] += len(cases)
            before = kernel.LAUNCHES[program]
            results = simulate.run_grid(kind, cases, seed=seed, **kw)
            grid[label] = results
            device_s = sum(r.device_s for r in results)
            per_n = {}
            for r in results:
                per_n[r.case.n_objects] = per_n.get(r.case.n_objects, 0.0) + r.device_s
            by_rate = {f"{r.case.rate:.3f}": round(r.device_s, 6) for r in results if r.case.n_objects == 100_000}
            mean_chr = sum(r.mean_chr for r in results) / len(results)
            byte_chr = ([r.mean_byte_chr for r in results] if results[0].mean_byte_chr is not None else None)
            mean_byte_chr = None if byte_chr is None else sum(byte_chr) / len(byte_chr)
            print(f"[grid {label}] program={program} cases={len(results)} "
                  f"launches={kernel.LAUNCHES[program] - before} grid_mean_chr={mean_chr} "
                  f"grid_mean_byte_chr={mean_byte_chr} device_s={device_s} "
                  f"j_per_request={device_s * card.power_limit_w / (len(results) * n_requests / len(paper))} "
                  f"device_s_by_n={json.dumps({k: round(v, 6) for k, v in per_n.items()})} "
                  f"n100k_device_s_by_rate={json.dumps(by_rate)} card={card.label!r} "
                  f"elapsed_s={time.perf_counter() - t1:.3f}", flush=True)
            for r in results:
                values = (r.mean_chr, r.std_chr, r.mean_evictions, r.mean_metadata, r.device_s)
                require(all(math.isfinite(v) for v in values), f"non-finite metric in {label} {r.case}")
                require(0.0 <= r.mean_chr <= 1.0 and r.mean_evictions >= 0 and r.mean_metadata >= 1,
                        f"out-of-range metric in {label} {r.case}: {r}")
                require(bool(kw) == (r.mean_byte_chr is not None), f"byte CHR of {label} {r.case}")
                if r.mean_byte_chr is not None:
                    require(0.0 <= r.mean_byte_chr <= 1.0, f"byte CHR out of range in {label} {r.case}")
        launches = dict(kernel.LAUNCHES)
        require(launches == expected, f"the grid launched {launches}, expected {expected}")
        chr_of = {label: sum(r.mean_chr for r in v) / len(v) for label, v in grid.items()}
        # the paper's finding: keeping parked counts (plfu) beats in-memory lfu on Zipf traffic
        require(chr_of["plfu"] > chr_of["lfu"], f"plfu CHR {chr_of['plfu']} <= lfu CHR {chr_of['lfu']}")
        # the derived metrics against the plain version on the CPU, smallest case
        for label, future in references.items():
            card_row = grid[label][0]
            cpu = future.result()
            same = cpu == (card_row.mean_chr, card_row.std_chr, card_row.mean_evictions, card_row.mean_metadata,
                           card_row.mean_byte_chr)
            require(same, f"{label} {paper[0]}: card {card_row} != cpu {cpu}")
        print(f"[grid] launches={json.dumps(launches)} total={sum(launches.values())} plfu_gt_lfu=True "
              f"grid_mean_chr={json.dumps(chr_of)} cpu_reference_case={paper[0]} "
              f"cpu_reference_rows={len(references)} elapsed_s={time.perf_counter() - t0:.3f}", flush=True)

        # the small checks' plain runs, back from the CPU workers
        t0 = time.perf_counter()
        n_cpu = len(checks.pending)
        checks.finish()
        print(f"[check] cases={checks.count} (plain on the CPU: {n_cpu}) samples={SAMPLES} "
              f"base_T={BASE_CHECK_LEN} (cut from 20,000) max_abs_err={max(checks.worst.values())} "
              f"tolerance=exact wait_s={time.perf_counter() - t0:.3f}", flush=True)

    # 5. scan: arc's scan resistance at benchmarks/scan_bench.py's full setting
    t0 = time.perf_counter()
    traces = {
        "scan": generators.scan(SCAN_N, SCAN_SAMPLES, SCAN_LEN, seed=SCAN_SEED, **SCAN_KW),
        "stationary": generators.stationary(SCAN_N, SCAN_SAMPLES, SCAN_LEN, seed=SCAN_SEED),
    }
    scan_chr = {}
    for kind, extra in SCAN_KINDS:
        chrs = {}
        for scenario, tr in traces.items():
            hits = kernel.cache_sim_cuda(torch.as_tensor(tr, device="cuda"), kind=kind, n_objects=SCAN_N,
                                         capacity=SCAN_CAP, **extra)["hits"]
            chrs[scenario] = int(hits.sum()) / tr.size
        scan_chr[kind] = chrs["scan"]
        print(f"[scan {kind}] options={json.dumps(extra)} chr={chrs['scan']} stationary_chr={chrs['stationary']} "
              f"scan_cost={chrs['stationary'] - chrs['scan']}")
    require(scan_chr["arc"] > scan_chr["lru"] and scan_chr["arc"] > scan_chr["lfu"],
            f"arc does not beat lru and lfu on scan: {scan_chr}")
    print(f"[scan] N={SCAN_N} cap={SCAN_CAP} S={SCAN_SAMPLES} T={SCAN_LEN} seed={SCAN_SEED} "
          f"sweeps={json.dumps(SCAN_KW)} arc_gt_lru_and_lfu=True elapsed_s={time.perf_counter() - t0:.3f}")

    # profile: the device's idle share between the launches of one grid row
    profile_row(seed, card)

    # 6. measure
    traces = torch.as_tensor(zipf.sample_traces(MEASURE_N, SAMPLES, MEASURE_LEN, seed=seed), device="cuda")
    short = traces[:, :PLAIN_MEASURE_LEN].contiguous()
    sizes = simulate.bytes_catalogue(MEASURE_N)
    entries, offs = [], {}
    for program, (kind, with_budget) in MEASURED.items():
        t0 = time.perf_counter()
        kw = dict(kind=kind, n_objects=MEASURE_N, capacity=MEASURE_CAP, **grid_options(kind))
        if with_budget:
            kw.update(sizes=sizes, capacity_bytes=simulate.bytes_budget(sizes, MEASURE_CAP))
        require(kernel.program_of(kind, kw.get("capacity_bytes", 0)) == program, f"{program} measures {kind}")
        spec = kernel.spec_of(**{k: v for k, v in kw.items() if k != "sizes"})
        tm = timing.measure(kernel.cache_sim_cuda, traces, steps=traces.numel(), repeats=5, warmup=1, **kw)
        got = kernel.cache_sim_cuda(traces, **kw)
        offs[program] = got
        want, plain_ms = cuda_ms(lambda: kernel.cache_sim_plain(short, **kw))
        err = max_abs_err(kernel.cache_sim_cuda(short, **kw), want)
        require(err == 0, f"kernel != plain version at the measured case of {program} (T={PLAIN_MEASURE_LEN})")
        b = bound(program, got, spec, card, sms, MEASURE_N if spec.size_aware else 0)
        kernel_ms = tm.execute_s * 1e3
        print(f"[measure {program}] kind={kind} N={MEASURE_N} cap={MEASURE_CAP} S={SAMPLES} T={MEASURE_LEN} "
              f"options={option_text(spec, 'lognormal' if spec.size_aware else None)} "
              f"kernel_ms={kernel_ms} kernel_mean_ms={tm.mean_execute_s * 1e3} repeats={tm.repeats} "
              f"plain_ms={plain_ms} plain_T={PLAIN_MEASURE_LEN} {' '.join(f'{k}={v}' for k, v in b.items())} "
              f"(peak = {sms} SMs x {INT32_LANES_PER_SM} lanes x {card.max_sm_clock_mhz} MHz) "
              f"j_per_request={tm.j_per_step} max_abs_err={err} card={card.label!r} "
              f"elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
        entries.append({
            "name": program, "route": "cuda", "source": str(Path(SOURCE_DIR) / kernel.PROGRAMS[program].source.name),
            "replaces": REPLACES[program], "launches": launches[program],
            "max_abs_err": max(checks.worst[program], err), "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
            "T": MEASURE_LEN, "plain_T": PLAIN_MEASURE_LEN,
        })

    # 7. telemetry: the telemetry path at the measured case, counted
    entries += run_telemetry(traces, offs, checks, card, sms, seed)

    # 8. kernels
    print(json.dumps({"kernels": entries}))
    print(f"[total] elapsed_s={time.perf_counter() - t_start:.3f}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
