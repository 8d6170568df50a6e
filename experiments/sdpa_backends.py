#!/usr/bin/env python3
"""Time each ``scaled_dot_product_attention`` backend beside the port's flash
kernel at MLA's prefill shape, on one card.

    python3 experiments/sdpa_backends.py [--repeats 20]

The shape is deepseek-v2-236b's MLA prefill: (B, H, KH, S, D) = (1, 128, 128,
2,048, 192), causal, bf16. Prints the backend SDPA's own dispatch picks, then
the device ms (CUDA events around ``--repeats`` calls after a warm-up) of the
kernel and of SDPA restricted to each backend in turn (a backend that refuses
the inputs says so), kernel first, then in reverse order, and the card's name
and power limit. SDPA is timed only: the port never calls it. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.flash_attention import flash_attention as flash  # noqa: E402

SHAPE = (1, 128, 128, 2_048, 192)
BACKENDS = (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH)


def events_ms(fn, repeats: int) -> float:
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card", file=sys.stderr)
        return 1
    b, h, kh, s, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, kh, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, kh, s, d, generator=gen, device="cuda").bfloat16()
    names = {int(x): name for name, x in SDPBackend.__members__.items()}
    print(f"[sdpa] shape=(B, H, KH, S, D)={SHAPE} causal=True dtype=bfloat16 "
          f"dispatch_picks={names[torch._fused_sdp_choice(q, k, v, is_causal=True, enable_gqa=True)]}", flush=True)

    def kernel():
        return flash.flash_attention_cuda(q, k, v, causal=True)

    def restricted(backend):
        def run():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        return run

    runs = [("kernel", kernel)] + [(x.name, restricted(x)) for x in BACKENDS]
    times: dict[str, list] = {name: [] for name, _ in runs}
    for order in (runs, runs[::-1]):
        for name, fn in order:
            try:
                times[name].append(events_ms(fn, args.repeats))
            except RuntimeError as err:
                times[name].append(f"refused: {str(err).splitlines()[0][:100]}")
    for name, got in times.items():
        print(f"[sdpa] {name} ms={got}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
