#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 0]

The kernel ``cache_sim`` has four programs, each its own CUDA source:
``cache_sim`` (lru, lfu, plfu, plfua), ``cache_sim/wlfu``,
``cache_sim/tinylfu`` (with or without the doorkeeper) and
``cache_sim/plfua_dyn``. Phases, one line each (or one line per item):

1. device  — the card's name and count, and ``nvidia-smi``'s name and power limit.
2. build   — nvcc builds the four programs from ``src/repro_torch/.../csrc``,
             one process each, all started together; prints ptxas's register
             and shared-memory report for each.
3. check   — each program against its plain PyTorch version on the card, exact
             on hits, freq, in_cache and inserts, at S = 12:
             lru/lfu/plfu/plfua at T = 10,000 and four (N, cap) up to
             N = 100,000; wlfu, tinylfu without and with the doorkeeper, and
             plfua_dyn at (N, cap, T) = (10,000, 200, 20,500) (many agings and
             refreshes, and a tail that must not refresh), (100,000, 2,000,
             20,000) (one refresh, at the last step) and a small case with
             explicit window, sketch width, refresh and hot-set size.
4. grid    — ``simulate.run_grid``: the paper's 60 cases x 12 samples x 100,000
             requests for each of the seven kinds, with every program's launch
             count set to 0 just before and read just after (240 launches of
             ``cache_sim``, 60 of each other program); the smallest case's
             metrics of each kind are held to the same case run by the plain
             version on the CPU, and plfu's CHR must beat lfu's.
5. measure — each program at N = 100,000, cap = 2,000, S = 12, T = 100,000
             (``cache_sim`` through lfu): the kernel's time from CUDA events
             after a warm-up, the plain version's time once, and the least time
             the card could take (bound).
6. kernels — one JSON line, an entry per program.

The last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before it; without a card the script exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch._device import card_info  # noqa: E402
from repro_torch.core import simulate, sketch, zipf  # noqa: E402
from repro_torch.kernels.cache_sim import cache_sim as kernel  # noqa: E402
from repro_torch.telemetry import timing  # noqa: E402

BASE_KINDS = ("lru", "lfu", "plfu", "plfua")
ADMISSION_KINDS = ("wlfu", "tinylfu", "plfua_dyn")
KINDS = BASE_KINDS + ADMISSION_KINDS
SAMPLES = 12
# the base program's check, cut from T = 20,000 to 10,000 to make room for the
# admission programs' checks within the script's time
BASE_CHECK_CASES = ((100, 2), (10_000, 200), (46_416, 4_225), (100_000, 2_000))
BASE_CHECK_LEN = 10_000
# (N, cap, T, explicit options): the admission programs' checks
ADMISSION_CHECK_CASES = (
    (10_000, 200, 20_500, {}),
    (100_000, 2_000, 20_000, {}),
    (130, 3, 2_000, dict(window=33, refresh=50, sketch_width=96, hot_size=7)),
)
MEASURE_N, MEASURE_CAP, MEASURE_LEN = 100_000, 2_000, 100_000
# the kind each program is checked and measured through
MEASURED_KIND = {"cache_sim": "lfu", "cache_sim/wlfu": "wlfu", "cache_sim/tinylfu": "tinylfu",
                 "cache_sim/plfua_dyn": "plfua_dyn"}
SOURCE_DIR = "src/repro_torch/kernels/cache_sim/csrc"
TPU_KERNEL = "src/repro/kernels/cache_sim/cache_sim.py"
REPLACES = {  # the TPU kernel's program each one replaces
    "cache_sim": f"{TPU_KERNEL}:187",  # _cache_sim_kernel (base_step, l.320)
    "cache_sim/wlfu": f"{TPU_KERNEL}:465",  # wlfu_step
    "cache_sim/tinylfu": f"{TPU_KERNEL}:499",  # tinylfu_step (+ sketch primitives, l.105-151)
    "cache_sim/plfua_dyn": f"{TPU_KERNEL}:154",  # _refresh_hot (+ the chunked loop, l.665)
}
#: H100 SXM HBM3 rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: INT32 lanes per Hopper SM: 4 partitions x 16 (the Hopper architecture white paper)
INT32_LANES_PER_SM = 64


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def max_abs_err(got, want) -> int:
    require(len(got) == len(want) == 4, "a wrapper returned other than (hits, freq, in_cache, inserts)")
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


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


def option_text(spec) -> str:
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
    return json.dumps(opts)


def check_program(kind: str, n: int, cap: int, trace_len: int, seed: int, **kw) -> int:
    """One check: the kernel against the plain version on the same traces."""
    t1 = time.perf_counter()
    spec = kernel.spec_of(kind, n, cap, **kw)
    traces = torch.as_tensor(zipf.sample_traces(n, SAMPLES, trace_len, seed=seed), device="cuda")
    got = kernel.cache_sim_cuda(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    want = kernel.cache_sim_plain(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    print(f"[check {kind}] program={kernel.PROGRAM_OF[kind]} n_objects={n} capacity={cap} T={trace_len} "
          f"options={option_text(spec)} hits={int(got[0].sum())} inserts={int(got[3].sum())} "
          f"max_abs_err={err} elapsed_s={time.perf_counter() - t1:.3f}")
    require(err == 0, f"kernel != plain version for {kind} N={n} cap={cap} T={trace_len} {kw}")
    return err


def bound(program: str, got, spec, card, sms: int) -> dict:
    """The least time the card could take for the measured call: the larger of
    its bytes (inputs read once, outputs written once) over the HBM rate and
    its operations, counted from this run's outputs, over the INT32 peak."""
    hits, freq, in_cache, inserts = got
    s, n = freq.shape
    trace_len = MEASURE_LEN
    requests = s * trace_len
    occupancy = int(in_cache.sum())
    evictions = int(inserts.sum()) - occupancy
    n_bytes = (requests * 4 + sum(a.numel() * a.element_size() for a in got))
    width = spec.effective_sketch_width
    counted = {"evictions": evictions}
    if program == "cache_sim/tinylfu":
        # a full cache stays full, so every miss after the first `occupancy` is a
        # duel, each with the victim's argmin (N compares) and two estimates
        duels = requests - int(hits.sum()) - occupancy
        agings = s * (trace_len // spec.effective_window)
        operations = duels * (n + 2 * sketch.DEPTH) + requests * sketch.DEPTH + agings * sketch.DEPTH * width
        counted.update(duels=duels, agings=agings)
    else:
        operations = evictions * n  # one (key, id) compare per id per eviction
        if program == "cache_sim/wlfu":
            operations += 2 * requests  # the window's two count updates a step
        if program == "cache_sim/plfua_dyn":
            refreshes = s * (trace_len // spec.effective_refresh)
            passes = sketch.DEPTH + 2 * math.ceil(math.log2(n))  # estimates + the two searches
            operations += requests * sketch.DEPTH + refreshes * (n * passes + sketch.DEPTH * width)
            counted.update(refreshes=refreshes, passes_per_refresh=passes)
    int32_peak = sms * INT32_LANES_PER_SM * card.max_sm_clock_mhz * 1e6
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, operations / int32_peak * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    return dict(bytes=n_bytes, operations=operations, int32_peak_ops_per_s=int32_peak, bytes_ms=bytes_ms,
                operations_ms=ops_ms, bound_ms=bound_ms, bound_by=bound_by, **counted)


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

    # 2. build: one nvcc per program, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernel.PROGRAMS)) as pool:
        built = dict(zip(kernel.PROGRAMS, pool.map(kernel.library, kernel.PROGRAMS)))
    for program, lib in built.items():
        usage = [line for line in lib.ptxas if "Used" in line]
        require(bool(usage), f"ptxas printed no register report for {program}")
        print(f"[build {program}] library={lib.path.name} ptxas={usage}")
    print(f"[build] programs={len(built)} elapsed_s={time.perf_counter() - t0:.3f}")

    # 3. check: every program == its plain version, exactly
    t0 = time.perf_counter()
    worst = dict.fromkeys(kernel.PROGRAMS, 0)
    for n, cap in BASE_CHECK_CASES:
        for kind in BASE_KINDS:
            err = check_program(kind, n, cap, BASE_CHECK_LEN, seed)
            worst["cache_sim"] = max(worst["cache_sim"], err)
    n_checks = len(BASE_CHECK_CASES) * len(BASE_KINDS)
    for n, cap, trace_len, explicit in ADMISSION_CHECK_CASES:
        for kind in ADMISSION_KINDS:
            variants = [{}]
            if kind == "tinylfu":
                variants.append(dict(doorkeeper=sketch.default_doorkeeper(cap)))
            for extra in variants:
                # options a kind does not take are ignored, as the reference does
                kw = {**grid_options(kind), **explicit, **extra}
                err = check_program(kind, n, cap, trace_len, seed, **kw)
                program = kernel.PROGRAM_OF[kind]
                worst[program] = max(worst[program], err)
                n_checks += 1
    print(f"[check] cases={n_checks} samples={SAMPLES} base_T={BASE_CHECK_LEN} (cut from 20,000) "
          f"max_abs_err={max(worst.values())} tolerance=exact elapsed_s={time.perf_counter() - t0:.3f}")

    # 4. grid: the main path, through every program
    t0 = time.perf_counter()
    n_cases = len(zipf.paper_grid())
    n_requests = n_cases * zipf.PAPER_NUM_SAMPLES * zipf.PAPER_TRACE_LEN
    grid = {}
    for program in kernel.LAUNCHES:
        kernel.LAUNCHES[program] = 0
    for kind in KINDS:
        t1 = time.perf_counter()
        program = kernel.PROGRAM_OF[kind]
        before = kernel.LAUNCHES[program]
        rows = simulate.run_grid(kind, seed=seed)
        grid[kind] = rows
        device_s = sum(r.device_s for r in rows)
        per_n = {}
        for r in rows:
            per_n[r.case.n_objects] = per_n.get(r.case.n_objects, 0.0) + r.device_s
        n100k = {f"{r.case.rate:.3f}": round(r.device_s, 6) for r in rows if r.case.n_objects == 100_000}
        mean_chr = sum(r.mean_chr for r in rows) / len(rows)
        print(f"[grid {kind}] program={program} cases={len(rows)} launches={kernel.LAUNCHES[program] - before} "
              f"grid_mean_chr={mean_chr} device_s={device_s} j_per_request={device_s * card.power_limit_w / n_requests} "
              f"device_s_by_n={json.dumps({k: round(v, 6) for k, v in per_n.items()})} "
              f"n100k_device_s_by_rate={json.dumps(n100k)} card={card.label!r} "
              f"elapsed_s={time.perf_counter() - t1:.3f}")
        for r in rows:
            values = (r.mean_chr, r.std_chr, r.mean_evictions, r.mean_metadata, r.device_s)
            require(all(math.isfinite(v) for v in values), f"non-finite metric in {kind} {r.case}")
            require(0.0 <= r.mean_chr <= 1.0 and r.mean_evictions >= 0 and r.mean_metadata >= 1,
                    f"out-of-range metric in {kind} {r.case}: {r}")
    launches = dict(kernel.LAUNCHES)
    for program in kernel.PROGRAMS:
        kinds = [k for k in KINDS if kernel.PROGRAM_OF[k] == program]
        require(launches[program] == len(kinds) * n_cases,
                f"the grid launched {program} {launches[program]} times, expected {len(kinds) * n_cases}")
    chr_of = {k: sum(r.mean_chr for r in v) / len(v) for k, v in grid.items()}
    # the paper's finding: keeping parked counts (plfu) beats in-memory lfu on Zipf traffic
    require(chr_of["plfu"] > chr_of["lfu"], f"plfu CHR {chr_of['plfu']} <= lfu CHR {chr_of['lfu']}")
    # the derived metrics against the plain version on the CPU, smallest case
    small = zipf.paper_grid()[0]
    for kind in KINDS:
        cpu = simulate.run_case(kind, small, seed=seed, device="cpu")
        card_row = grid[kind][0]
        same = (cpu.mean_chr, cpu.std_chr, cpu.mean_evictions, cpu.mean_metadata) == (
            card_row.mean_chr, card_row.std_chr, card_row.mean_evictions, card_row.mean_metadata)
        require(same, f"{kind} {small}: card {card_row} != cpu {cpu}")
    print(f"[grid] launches={json.dumps(launches)} total={sum(launches.values())} plfu_gt_lfu=True "
          f"grid_mean_chr={json.dumps(chr_of)} cpu_reference_case={small} "
          f"elapsed_s={time.perf_counter() - t0:.3f}")

    # 5. measure
    traces = torch.as_tensor(
        zipf.sample_traces(MEASURE_N, SAMPLES, MEASURE_LEN, seed=seed), device="cuda")
    entries = []
    for program, kind in MEASURED_KIND.items():
        t0 = time.perf_counter()
        kw = dict(kind=kind, n_objects=MEASURE_N, capacity=MEASURE_CAP, **grid_options(kind))
        spec = kernel.spec_of(**kw)
        tm = timing.measure(kernel.cache_sim_cuda, traces, steps=traces.numel(), repeats=5, warmup=1, **kw)
        got = kernel.cache_sim_cuda(traces, **kw)
        want, plain_ms = cuda_ms(lambda: kernel.cache_sim_plain(traces, **kw))
        err = max_abs_err(got, want)
        require(err == 0, f"kernel != plain version at the measured case of {program}")
        b = bound(program, got, spec, card, sms)
        kernel_ms = tm.execute_s * 1e3
        print(f"[measure {program}] kind={kind} N={MEASURE_N} cap={MEASURE_CAP} S={SAMPLES} T={MEASURE_LEN} "
              f"options={option_text(spec)} "
              f"kernel_ms={kernel_ms} kernel_mean_ms={tm.mean_execute_s * 1e3} repeats={tm.repeats} "
              f"plain_ms={plain_ms} {' '.join(f'{k}={v}' for k, v in b.items())} "
              f"(peak = {sms} SMs x {INT32_LANES_PER_SM} lanes x {card.max_sm_clock_mhz} MHz) "
              f"j_per_request={tm.j_per_step} max_abs_err={err} card={card.label!r} "
              f"elapsed_s={time.perf_counter() - t0:.3f}")
        entries.append({
            "name": program, "route": "cuda", "source": str(Path(SOURCE_DIR) / kernel.PROGRAMS[program].source.name),
            "replaces": REPLACES[program], "launches": launches[program],
            "max_abs_err": max(worst[program], err), "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None,
        })

    # 6. kernels
    print(json.dumps({"kernels": entries}))
    print(f"[total] elapsed_s={time.perf_counter() - t_start:.3f}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
