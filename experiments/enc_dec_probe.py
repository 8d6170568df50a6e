#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s encoder-decoder and vlm phases (19a, 19b) alone on one card.

    python3 experiments/enc_dec_probe.py [--seed 0]

Prints the card's name and power limit and the host's CPU, then builds the
flash kernel and checks it at whisper's and llava's served shapes (each in
f32 and bf16 against the plain version, the wrong versions rejected), runs
phases 19a and 19b as the script does (``whisper_serve``, ``whisper_check``,
``llava_serve``, ``llava_check`` and the flash measure at their shapes), and
prints each phase's seconds. Needs a CUDA card; about 2 minutes.
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t = time.perf_counter()
    cs.flash.library()
    print(f"[build] elapsed_s={time.perf_counter() - t:.3f}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.FLASH_SWEEP = ()
    cs.FLASH_SERVED = tuple(c for c in cs.FLASH_SERVED if c[1:3] in ((20, 20), (32, 8)))
    t = time.perf_counter()
    worst = cs.flash_checks(seed)
    print(f"[phase] flash check at the new shapes s={time.perf_counter() - t:.3f}", flush=True)
    for name, serve, check, shapes in (("19a whisper", cs.whisper_serve, cs.whisper_check, cs.WHISPER_FLASH_SHAPES),
                                       ("19b llava", cs.llava_serve, cs.llava_check, cs.LLAVA_FLASH_SHAPES)):
        t = time.perf_counter()
        model, by_entry, reqs = serve(seed, card)
        t_serve = time.perf_counter()
        check(model, reqs, seed)
        del model, reqs
        torch.cuda.empty_cache()
        t_check = time.perf_counter()
        cs.flash_measure(seed, worst, by_entry, sms, shapes=shapes)
        print(f"[phase] {name} serve_s={t_serve - t:.3f} check_s={t_check - t_serve:.3f} "
              f"flash_measure_s={time.perf_counter() - t_check:.3f} s={time.perf_counter() - t:.3f}", flush=True)
    print(f"[total] elapsed_s={time.perf_counter() - t0:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("experiments/enc_dec_probe.py runs on a CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
