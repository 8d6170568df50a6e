#!/usr/bin/env python3
"""What the cache_sim wrapper's library loader costs a timed call, on one card.

    python3 experiments/cache_sim_loader_cost.py

``cache_sim.library(program)`` hashes the program's sources and headers on
every call to find its built library. The script times that call on the host
(200 calls), then plfua_dyn at the measured case (N = 100,000, cap = 2,000,
S = 12, T = 100,000) with CUDA events around five ``cache_sim_cuda`` calls,
through the wrapper's loader and through one that returns the library already
loaded, in turns (wrapper, cached, cached, wrapper). Each call syncs on the
host (its id check), so the loader's time shows in the events' span. Needs a
CUDA card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import zipf  # noqa: E402
from repro_torch.kernels.cache_sim import cache_sim as kernel  # noqa: E402


def events_ms(fn, repeats: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card", file=sys.stderr)
        return 1
    traces = torch.as_tensor(zipf.sample_traces(100_000, 12, 100_000, seed=0), device="cuda")
    kw = dict(kind="plfua_dyn", n_objects=100_000, capacity=2_000)
    lib = kernel.library("cache_sim/plfua_dyn")
    t0 = time.perf_counter()
    for _ in range(200):
        kernel.library("cache_sim/plfua_dyn")
    print("library() host us a call", (time.perf_counter() - t0) / 200 * 1e6, flush=True)
    loader = kernel.library
    out = {"wrapper_loader": [], "cached_loader": []}
    for order in (("wrapper_loader", "cached_loader"), ("cached_loader", "wrapper_loader")):
        for name in order:
            kernel.library = loader if name == "wrapper_loader" else (lambda program="cache_sim", lib=lib: lib)
            out[name].append(events_ms(lambda: kernel.cache_sim_cuda(traces, **kw)))
    kernel.library = loader
    print("plfua_dyn N=100000 cap=2000 S=12 T=100000 ms", out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
