#!/usr/bin/env python3
"""Print the evictions ``chip_smoke.py``'s fast stream rows make at their depth, on one card.

    python3 experiments/stream_depth.py

Draws each row of ``STREAM_FAST_ROWS`` (lru, tinylfu and plfua_dyn at
N = 2**16, capacity 2**12, chunks of 1,024) on the card as the stream phase
draws it, runs the cache_sim program over its chunks concatenated, and
prints the distinct ids and the evictions at the row's chunk count: the
depth the stream phase needs (lru and tinylfu must evict). Needs a CUDA
card; under a minute.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    for kind, seed, opts, n_chunks in cs.STREAM_FAST_ROWS:
        dspec = cs.device_workloads.DeviceTraceSpec("stationary", cs.STREAM_FAST_N, n_samples=1,
                                                    trace_len=cs.STREAM_FAST_CHUNK, seed=seed)
        traces = torch.cat([cs.device_workloads.gen_stream_chunk(dspec, 0, c, device="cuda")
                            for c in range(n_chunks)])[None]
        got = cs.kernel.cache_sim_cuda(traces, kind=kind, n_objects=cs.STREAM_FAST_N, capacity=cs.STREAM_FAST_CAP,
                                       **opts)
        evictions = int(got["inserts"][0]) - int(got["in_cache"][0].sum())
        print(f"[stream depth] kind={kind} chunks={n_chunks} distinct={len(torch.unique(traces))} "
              f"evictions={evictions}", flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("experiments/stream_depth.py runs on a CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
