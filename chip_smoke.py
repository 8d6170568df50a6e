#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (or one line per item):

1. device  — the card's name and count, and ``nvidia-smi``'s name and power limit.
2. build   — nvcc builds the cache_sim kernel from ``src/repro_torch/.../csrc``;
             prints ptxas's register and shared-memory report.
3. check   — the kernel against its plain PyTorch version on the card, exact on
             hits, freq and in_cache, for lru/lfu/plfu/plfua at S = 12,
             T = 20,000 and four (N, cap) up to N = 100,000.
4. grid    — ``simulate.run_grid``: the paper's 60 cases x 12 samples x 100,000
             requests for each of the four kinds, with the launch count set to 0
             just before and read just after (240 launches expected); the
             smallest case's metrics are held to the same case run by the plain
             version on the CPU.
5. measure — lfu at N = 100,000, cap = 2,000, S = 12, T = 100,000: the kernel's
             time from CUDA events after a warm-up, the plain version's time
             once, and the least time the card could take (bound).
6. kernels — one JSON line per the port's kernel table.

The last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before it; without a card the script exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch._device import card_info  # noqa: E402
from repro_torch.core import simulate, zipf  # noqa: E402
from repro_torch.kernels.cache_sim import cache_sim as kernel  # noqa: E402
from repro_torch.telemetry import timing  # noqa: E402

KINDS = ("lru", "lfu", "plfu", "plfua")
CHECK_CASES = ((100, 2), (10_000, 200), (46_416, 4_225), (100_000, 2_000))
CHECK_SAMPLES, CHECK_LEN = 12, 20_000
MEASURE = dict(kind="lfu", n_objects=100_000, capacity=2_000)
MEASURE_SAMPLES, MEASURE_LEN = 12, 100_000
SOURCE = "src/repro_torch/kernels/cache_sim/csrc/cache_sim.cu"
REPLACES = "src/repro/kernels/cache_sim/cache_sim.py:187"
#: H100 SXM HBM3 rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: INT32 lanes per Hopper SM: 4 partitions x 16 (the Hopper architecture white paper)
INT32_LANES_PER_SM = 64


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def max_abs_err(got, want) -> int:
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


def evictions_of(hits, in_cache, trace_len) -> int:
    """lfu/plfu/lru: every miss inserts, so evictions = misses - occupancy."""
    return int((trace_len - hits.to(torch.int64) - in_cache.sum(dim=1)).sum())


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

    # 2. build
    t0 = time.perf_counter()
    built = kernel.library()
    usage = [line for line in built.ptxas if "Used" in line]
    require(bool(usage), "ptxas printed no register report")
    print(f"[build] library={built.path.name} ptxas={usage} elapsed_s={time.perf_counter() - t0:.3f}")

    # 3. check: kernel == plain version, exactly
    t0 = time.perf_counter()
    worst = 0
    for n, cap in CHECK_CASES:
        traces = torch.as_tensor(zipf.sample_traces(n, CHECK_SAMPLES, CHECK_LEN, seed=seed), device="cuda")
        for kind in KINDS:
            t1 = time.perf_counter()
            got = kernel.cache_sim_cuda(traces, kind=kind, n_objects=n, capacity=cap)
            want = kernel.cache_sim_plain(traces, kind=kind, n_objects=n, capacity=cap)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            worst = max(worst, err)
            print(f"[check {kind}] n_objects={n} capacity={cap} hits={int(got[0].sum())} "
                  f"max_abs_err={err} elapsed_s={time.perf_counter() - t1:.3f}")
            require(err == 0, f"kernel != plain version for {kind} N={n} cap={cap}")
    print(f"[check] cases={len(CHECK_CASES) * len(KINDS)} samples={CHECK_SAMPLES} T={CHECK_LEN} "
          f"max_abs_err={worst} tolerance=exact elapsed_s={time.perf_counter() - t0:.3f}")

    # 4. grid: the main path, through the kernel
    t0 = time.perf_counter()
    n_requests = len(zipf.paper_grid()) * zipf.PAPER_NUM_SAMPLES * zipf.PAPER_TRACE_LEN
    grid = {}
    kernel.LAUNCHES = 0
    for kind in KINDS:
        t1 = time.perf_counter()
        before = kernel.LAUNCHES
        rows = simulate.run_grid(kind, seed=seed)
        grid[kind] = rows
        device_s = sum(r.device_s for r in rows)
        per_n = {}
        for r in rows:
            per_n[r.case.n_objects] = per_n.get(r.case.n_objects, 0.0) + r.device_s
        n100k = {f"{r.case.rate:.3f}": round(r.device_s, 6) for r in rows if r.case.n_objects == 100_000}
        mean_chr = sum(r.mean_chr for r in rows) / len(rows)
        print(f"[grid {kind}] cases={len(rows)} launches={kernel.LAUNCHES - before} grid_mean_chr={mean_chr} "
              f"device_s={device_s} j_per_request={device_s * card.power_limit_w / n_requests} "
              f"device_s_by_n={json.dumps({k: round(v, 6) for k, v in per_n.items()})} "
              f"n100k_device_s_by_rate={json.dumps(n100k)} card={card.label!r} "
              f"elapsed_s={time.perf_counter() - t1:.3f}")
        for r in rows:
            values = (r.mean_chr, r.std_chr, r.mean_evictions, r.mean_metadata, r.device_s)
            require(all(math.isfinite(v) for v in values), f"non-finite metric in {kind} {r.case}")
            require(0.0 <= r.mean_chr <= 1.0 and r.mean_evictions >= 0 and r.mean_metadata >= 1,
                    f"out-of-range metric in {kind} {r.case}: {r}")
    launches = kernel.LAUNCHES
    require(launches == len(KINDS) * len(zipf.paper_grid()),
            f"the grid launched the kernel {launches} times, expected {len(KINDS) * len(zipf.paper_grid())}")
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
    print(f"[grid] launches={launches} plfu_gt_lfu=True cpu_reference_case={small} "
          f"elapsed_s={time.perf_counter() - t0:.3f}")

    # 5. measure
    t0 = time.perf_counter()
    n, cap = MEASURE["n_objects"], MEASURE["capacity"]
    traces = torch.as_tensor(zipf.sample_traces(n, MEASURE_SAMPLES, MEASURE_LEN, seed=seed), device="cuda")
    tm = timing.measure(kernel.cache_sim_cuda, traces, steps=traces.numel(), repeats=5, warmup=1, **MEASURE)
    got = kernel.cache_sim_cuda(traces, **MEASURE)
    want, plain_ms = cuda_ms(lambda: kernel.cache_sim_plain(traces, **MEASURE))
    err = max_abs_err(got, want)
    require(err == 0, "kernel != plain version at the measured case")
    hits, freq, in_cache = got
    evictions = evictions_of(hits, in_cache, MEASURE_LEN)
    n_bytes = (traces.numel() * traces.element_size() + hits.numel() * hits.element_size()
               + freq.numel() * freq.element_size() + in_cache.numel() * in_cache.element_size())
    operations = evictions * n  # one (key, id) compare per id per eviction
    int32_peak = sms * INT32_LANES_PER_SM * card.max_sm_clock_mhz * 1e6
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, operations / int32_peak * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    kernel_ms = tm.execute_s * 1e3
    print(f"[measure] case=lfu N={n} cap={cap} S={MEASURE_SAMPLES} T={MEASURE_LEN} kernel_ms={kernel_ms} "
          f"kernel_mean_ms={tm.mean_execute_s * 1e3} repeats={tm.repeats} plain_ms={plain_ms} "
          f"evictions={evictions} bytes={n_bytes} operations={operations} "
          f"int32_peak_ops_per_s={int32_peak} (= {sms} SMs x {INT32_LANES_PER_SM} lanes x "
          f"{card.max_sm_clock_mhz} MHz) bytes_ms={bytes_ms} operations_ms={ops_ms} "
          f"bound_ms={bound_ms} bound_by={bound_by} j_per_request={tm.j_per_step} max_abs_err={err} "
          f"card={card.label!r} elapsed_s={time.perf_counter() - t0:.3f}")

    # 6. kernels
    print(json.dumps({"kernels": [{
        "name": "cache_sim", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max(worst, err), "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]}))
    print(f"[total] elapsed_s={time.perf_counter() - t_start:.3f}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
