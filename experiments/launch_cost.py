#!/usr/bin/env python3
"""The host's cost of a kernel launch from PyTorch, and what raises it.

    python3 experiments/launch_cost.py

Times a loop of small out-of-place ops (``y = x + 1`` on 1,024 floats, each
a kernel launch and a new tensor object) on one card, in µs a launch (host
clock around the loop, synchronised at its end), in turns:

  1. in a fresh process;
  2. with 3,000,000 small Python objects on the heap (the collector's passes
     walk them);
  3. the same heap frozen (``gc.freeze``);
  4. after one ``torch.profiler`` session with CUDA activity has ended (its
     CUPTI tracing set up in the process);
  5. the same again, to see whether the cost stays.

chip_smoke.py's train phase runs ~16,000 launches a step late in a process
that has profiled many times and holds the earlier phases' objects. Needs a
CUDA card; under a minute.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time

import torch

LAUNCHES = 20_000


def per_launch_us(x: torch.Tensor) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(LAUNCHES):
        y = x + 1.0
    torch.cuda.synchronize()
    del y
    return (time.perf_counter() - t) / LAUNCHES * 1e6


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi} torch={torch.__version__}", flush=True)
    x = torch.zeros(1024, device="cuda")
    per_launch_us(x)  # warm-up
    rows = {"fresh": per_launch_us(x)}
    heap = [{"a": [i, str(i)]} for i in range(3_000_000)]
    rows["heap of 3M objects"] = per_launch_us(x)
    gc.collect()
    gc.freeze()
    rows["heap frozen"] = per_launch_us(x)
    gc.unfreeze()
    del heap
    gc.collect()
    rows["fresh heap again"] = per_launch_us(x)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        per_launch_us(x)
    rows["after a profiler session"] = per_launch_us(x)
    rows["after a profiler session, again"] = per_launch_us(x)
    for name, us in rows.items():
        print(f"[launch] {name}: {us:.3f} us a launch ({LAUNCHES} launches) card={smi!r}", flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("experiments/launch_cost.py runs on a CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
