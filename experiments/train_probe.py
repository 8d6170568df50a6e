#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training phase (19c) alone on one card.

    python3 experiments/train_probe.py [--seed 0] [--breakdown]

Prints the card's name and power limit and the host's CPU, then runs phase
19c as the script does: smollm-360m trained at full width and depth (60
steps, no flash launch), the Trainer's checkpoints and resume on 2 layers
(restored onto the CPU bit for bit), the card's loss and gradients held to
the CPU's on those 2 layers with non-causal attention rejected, and the
launcher in process; then each part's seconds. Builds no kernel (training
runs none). Needs a CUDA card; under a minute. ``--breakdown`` first times
one full-depth step under ``torch.profiler`` after 3 warm-up steps: the
device time by kernel (the 15 longest, and the totals of the matrix products,
the rest, and the kernels' count), to show where a step's device time goes.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from repro_torch._device import card_info  # noqa: E402


#: substrings of the names of matrix-product kernels (cuBLAS, cuBLASLt, CUTLASS)
GEMM_NAMES = ("gemm", "cutlass", "xmma", "nvjet", "cublas")


def breakdown(seed: int, card) -> None:
    """One full-depth train step's device time by kernel, after 3 warm-up steps."""
    cfg = cs.get_config(cs.TRAIN_ARCH)
    model = cs.build(cfg, device="cuda")
    tcfg = cs.TrainConfig(opt=cs.OptConfig(lr=cs.TRAIN_LR, warmup_steps=cs.TRAIN_WARMUP, total_steps=cs.TRAIN_STEPS))
    params, state = cs.init_train_state(model, tcfg, torch.Generator(device="cuda").manual_seed(seed))
    stream = cs.ZipfBigramStream(cs.DataConfig(cfg.vocab_size, cs.TRAIN_SEQ, cs.TRAIN_BATCH))
    step_fn = cs.make_train_step(model, tcfg)
    for i in range(3):
        params, state, m = step_fn(params, state, stream.batch(i))
    torch.cuda.synchronize()
    batch = stream.batch(3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step_fn(params, state, batch)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    gemm = sum(us for us, _, k in rows if any(g in k.lower() for g in GEMM_NAMES))
    total = sum(us for us, _, _ in rows)
    print(f"[breakdown] arch={cfg.name} batch={cs.TRAIN_BATCH}x{cs.TRAIN_SEQ} device_ms={total / 1e3:.3f} "
          f"gemm_ms={gemm / 1e3:.3f} other_ms={(total - gemm) / 1e3:.3f} "
          f"kernels={sum(c for _, c, _ in rows)} card={card.label!r}", flush=True)
    for us, count, key in rows[:15]:
        print(f"[breakdown] {us / 1e3:9.3f} ms {count:6d}x {key[:110]}", flush=True)
    del model, params, state
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--breakdown", action="store_true")
    args = parser.parse_args()
    seed = args.seed
    t0 = time.perf_counter()
    card = card_info(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi} host_cpu={cs.host_cpu()!r} torch={torch.__version__} cuda={torch.version.cuda} "
          f"threads={torch.get_num_threads()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py sets it before its model phases
    if args.breakdown:
        breakdown(seed, card)
    seconds = {}
    t = time.perf_counter()
    cs.train_full(seed, card)
    torch.cuda.empty_cache()
    seconds["a full depth"] = time.perf_counter() - t
    t = time.perf_counter()
    model, masters = cs.train_resume(seed, card)
    seconds["b trainer"] = time.perf_counter() - t
    t = time.perf_counter()
    cs.train_check(model, masters, seed)
    del model, masters
    seconds["c check"] = time.perf_counter() - t
    t = time.perf_counter()
    cs.train_launch(card)
    seconds["d launcher"] = time.perf_counter() - t
    print(f"[phase] 19c {' '.join(f'{k.split()[0]}={v:.3f}' for k, v in seconds.items())} "
          f"s={sum(seconds.values()):.3f}", flush=True)
    print(f"[total] elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("experiments/train_probe.py runs on a CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
