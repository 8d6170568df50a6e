#!/usr/bin/env python3
"""Time variants of the flash kernel's bf16 prefill against each other on one card.

    python3 experiments/flash_variants.py [--repeats 50]

Each variant is the source in ``src/repro_torch/kernels/flash_attention/csrc``
with a few lines replaced, built by ``nvcc`` into ``build/flash_variants/``
(all builds at once). Every variant is held to the plain version on the bf16
prefill cases below (atol 1e-4, rtol 2**-7, as ``chip_smoke.py``); then each
is timed at the served shapes, in turns (each variant, then each again in
reverse order), with the host ahead of the device (``torch.cuda._sleep``
holds the stream while the calls are queued), beside
``scaled_dot_product_attention``. Variants:

* ``kernel``: the source as it is (2^x by ``ex2.approx``).
* ``exp2f``: 2^x by ``exp2f``.
* ``keys128``: 128-key tiles (S one m64n128 wgmma a k step).
* ``turns``: the two consumer warpgroups take turns to issue their products
  (named barriers), as FlashAttention-3's ping-pong schedule does.

Needs a CUDA card; prints one line a result and exits non-zero on a failed
build or check.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402

OUT = ROOT / "build" / "flash_variants"
KEYS = ("constexpr int kKeys = 64;", "constexpr int kKeys = 128;")
WGMMA_N128 = '''
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\\n}\\n"
      : ''' + ", ".join(f'"+f"(d[{i}])' for i in range(64)) + '''
      : "l"(a), "l"(b), "r"(scale_d));
}
'''
NAMED_BARRIERS = '''
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}
'''
#: two turns a tile (S, then P V), named barriers 1 and 2; a warpgroup past its rows keeps the turns
TURNS = [
    ("  mbar_wait(q_full, 0);\n", "  if (wg == 1) named_arrive(1, 256);\n  mbar_wait(q_full, 0);\n"),
    ("    if (n0 < wg_end) {\n", "    if (n0 >= wg_end) {\n      for (int turn = 0; turn < 2; ++turn) {\n"
     "        named_sync(1 + wg, 256);\n        named_arrive(2 - wg, 256);\n      }\n    }\n    if (n0 < wg_end) {\n"),
    ("      wgmma_fence();\n", "      named_sync(1 + wg, 256);\n      wgmma_fence();\n"),
    ("      wgmma_commit();\n", "      wgmma_commit();\n      named_arrive(2 - wg, 256);\n"),
    ("  // the row sums over the 4 threads of a row;", "  if (wg == 0) named_sync(1, 256);\n"
     "  // the row sums over the 4 threads of a row;"),
]
#: name: (replacements in flash_attention.cu, text appended to hopper.cuh)
VARIANTS = {
    "kernel": ([], ""),
    "exp2f": ([("fast_exp2(", "exp2f(")], ""),
    "keys128": ([KEYS, ("wgmma_ss_n64(s,", "wgmma_ss_n128(s,")], WGMMA_N128),
    "turns": (TURNS, NAMED_BARRIERS),
}
#: (B, H, KH, Sq, Skv, D, causal, kv_len): bf16 prefill edges and the served shapes
CASES = [
    (1, 2, 2, 64, 64, 16, True, None), (2, 3, 3, 64, 64, 32, True, None), (1, 3, 1, 17, 40, 16, True, 30),
    (1, 8, 8, 100, 300, 128, True, 250), (1, 8, 1, 100, 90, 64, False, None), (1, 4, 2, 100, 160, 64, True, 130),
    (1, 16, 2, 150, 150, 64, True, None), (1, 4, 2, 130, 200, 128, False, 180), (1, 15, 5, 520, 520, 64, True, None),
    (1, 24, 8, 1_024, 1_024, 128, True, None), (1, 15, 5, 2_048, 2_048, 64, True, None),
]
TIMED = [(1, 15, 5, 2_048, 64), (1, 15, 5, 16_384, 64), (1, 24, 8, 1_024, 128)]


def build(name: str) -> _build.Library:
    """The variant's library, from a patched copy of the sources."""
    reps, extra = VARIANTS[name]
    src_dir = fa.SOURCE.parent
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    text = fa.SOURCE.read_text()
    for old, new in reps:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    (out / fa.SOURCE.name).write_text(text)
    (out / "hopper.cuh").write_text((src_dir / "hopper.cuh").read_text() + extra)
    lib = _build.build(f"flash_{name}", [out / fa.SOURCE.name])
    lib.lib.flash_attention_launch.argtypes = list(fa.ARGTYPES)
    lib.lib.flash_attention_launch.restype = ctypes.c_int
    lib.lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def inputs(b, h, kh, sq, skv, d, seed, kv_len=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, n, s, d, generator=gen, device="cuda").to(torch.bfloat16)
               for n, s in ((h, sq), (kh, skv), (kh, skv)))
    if kv_len is not None:
        k[:, :, kv_len:] = 1e6
    return q, k, v


def device_ms(fn, repeats: int) -> float:
    """Mean device ms a call, the host ahead of the device (as chip_smoke.device_ms)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(max(3 * host_s, 0.02) * 1.98e9))  # at least 20 ms: room for the host's jitter
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    if start.query():
        raise RuntimeError("the device caught up with the host: the timing would include the host")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=50)
    repeats = parser.parse_args().repeats
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    print(f"[build] variants={list(libs)} elapsed_s={time.perf_counter() - t0:.1f}", flush=True)
    for name, lib in libs.items():
        spills = [line.strip() for line in lib.path.with_suffix(".log").read_text().splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(f"[build] {name} spilling kernels={len(spills)}", flush=True)

    want = {}
    for i, (b, h, kh, sq, skv, d, causal, kv_len) in enumerate(CASES):
        q, k, v = inputs(b, h, kh, sq, skv, d, i, kv_len)
        want[i] = (q, k, v, fa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len).float())
    for name, lib in libs.items():
        fa.library = lambda lib=lib: lib
        worst = 0.0
        for i, (q, k, v, ref) in want.items():
            got = fa.flash_attention_cuda(q, k, v, causal=CASES[i][6], kv_len=CASES[i][7]).float()
            worst = max(worst, float(((got - ref).abs() / (1e-4 + 2**-7 * ref.abs())).max()))
        print(f"[check] {name} cases={len(want)} worst_tol_ratio={worst}", flush=True)
        if not worst <= 1:
            return 1

    for b, h, kh, sq, d in TIMED:
        q, k, v = inputs(b, h, kh, sq, sq, d, 0)
        n = repeats if sq <= 2_048 else max(1, repeats // 5)
        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                fa.library = lambda lib=libs[name]: lib
                times[name].append(device_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True), n))
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True), n)
        print(f"[time] B={b} H={h} KH={kh} S={sq} D={d} causal bf16 ms: "
              + " ".join(f"{name}={t}" for name, t in times.items()) + f" sdpa={sdpa} card={smi!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
