#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s SSM phases alone on one card, with the host's rates.

    python3 experiments/ssm_probe.py [--seed 0]

Prints the card's name and power limit and the host's CPU, then the rates
that bound the card-vs-CPU checks: the host's bf16 matrix products (at 2,048,
256 and 8 rows against an 8,192 x 8,192 matrix, and one expert product of
jamba's capacity buffers), a device-to-host copy of 4.3 GB into pageable and
into pinned memory (and the pinning's own time), and whether ``normal_`` in
bf16 on the card gives the f32 draw times the scale rounded once (as
``Model.init`` takes it). Then builds the flash kernel, checks it at jamba's
served shapes, and runs phases 18 and 19 (``ssm_serve``, ``rwkv_check``,
``jamba_check``) and the flash measure at jamba's shapes, as the script does.
Needs a CUDA card; about 3 minutes.
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


def host_rates() -> None:
    for m in (2_048, 256, 8):
        a, b = torch.randn(m, 8_192).bfloat16(), torch.randn(8_192, 8_192).bfloat16()
        a @ b
        t = time.perf_counter()
        a @ b
        dt = time.perf_counter() - t
        print(f"[host] bf16 product rows={m} tflops={2 * m * 8_192 * 8_192 / dt / 1e12} s={dt}", flush=True)
    x, w = torch.randn(1, 4, 40, 8_192).bfloat16(), torch.randn(4, 8_192, 24_576).bfloat16()
    torch.einsum("becd,edf->becf", x, w)
    t = time.perf_counter()
    torch.einsum("becd,edf->becf", x, w)
    dt = time.perf_counter() - t
    print(f"[host] bf16 expert product tflops={2 * 4 * 40 * 8_192 * 24_576 / dt / 1e12} s={dt}", flush=True)
    g = torch.empty(2**31, dtype=torch.bfloat16, device="cuda").normal_()
    t = time.perf_counter()
    g.cpu()
    dt = time.perf_counter() - t
    print(f"[host] d2h pageable gb_per_s={g.numel() * 2 / dt / 1e9} s={dt}", flush=True)
    t = time.perf_counter()
    pinned = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
    pin_s = time.perf_counter() - t
    t = time.perf_counter()
    pinned.copy_(g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    print(f"[host] pin_s={pin_s} d2h pinned gb_per_s={g.numel() * 2 / dt / 1e9}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed
    t0 = time.perf_counter()
    card = card_info(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi} host_cpu={cs.host_cpu()!r} torch={torch.__version__} threads={torch.get_num_threads()}",
          flush=True)
    host_rates()
    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.empty(1_000, 1_000, device="cuda", dtype=torch.bfloat16).normal_(0, 0.02, generator=gen)
    gen = torch.Generator(device="cuda").manual_seed(3)
    b = (torch.randn(1_000, 1_000, generator=gen, device="cuda") * 0.02).bfloat16()
    print(f"[init] normal_ equals randn x scale rounded once (cuda, bf16): {bool(torch.equal(a, b))}", flush=True)
    t = time.perf_counter()
    cs.flash.library()
    print(f"[build] flash elapsed_s={time.perf_counter() - t:.3f}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.FLASH_SWEEP = ()
    cs.FLASH_SERVED = tuple(c for c in cs.FLASH_SERVED if c[1:3] == (64, 8))
    worst = cs.flash_checks(seed)
    launches = {}
    for arch in cs.SSM_ARCHS:
        t1 = time.perf_counter()
        model, launches[arch] = cs.ssm_serve(arch, seed, card)
        t2 = time.perf_counter()
        (cs.rwkv_check if arch == "rwkv6-7b" else cs.jamba_check)(model, seed)
        del model
        torch.cuda.empty_cache()
        print(f"[ssm] arch={arch} serve_s={t2 - t1:.3f} check_s={time.perf_counter() - t2:.3f}", flush=True)
    jamba = launches["jamba-1.5-large-398b"]
    cs.flash_measure(seed, worst, {cs.JAMBA_PREFILL_ENTRY: jamba[cs.flash.INSTANCES[0]],
                                   cs.JAMBA_DECODE_ENTRY: jamba[cs.flash.INSTANCES[1]]},
                     torch.cuda.get_device_properties(0).multi_processor_count, shapes=cs.JAMBA_FLASH_SHAPES)
    print(f"[total] elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("experiments/ssm_probe.py runs on a CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
