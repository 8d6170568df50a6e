#!/usr/bin/env python3
"""Time each kernel source's nvcc build with and without ``--split-compile``.

    python3 experiments/nvcc_split.py

Builds the port's seven CUDA sources (the six cache_sim sources and the flash
source) with ``kernels/_build.py``'s flags, all at once as ``chip_smoke.py``
builds them, first as they are, then with ``--split-compile=0`` (nvcc
optimises a source's kernels on as many threads as the host has cores), then
with ptxas split too; then the flash source alone each way. Prints the host's
CPU (``lscpu``), nvcc's version, each build's seconds and its first ptxas
register lines. Writes only under a temporary directory. Needs the CUDA
toolkit (no card); about 4 minutes on an 8-core host.
"""
from __future__ import annotations

import concurrent.futures
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

SOURCES = sorted((ROOT / "src/repro_torch/kernels/cache_sim/csrc").glob("*.cu")) + [
    ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"]


def one(src: Path, extra: list[str], tag: str, out: Path) -> tuple:
    t0 = time.perf_counter()
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(out / f"{src.stem}_{tag}.so"), str(src)],
                       capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = p.stdout + p.stderr
    regs = [line.strip()[:100] for line in log.splitlines() if "registers" in line][:3]
    return src.name, tag, p.returncode, round(seconds, 2), log[-600:] if p.returncode else regs


def main() -> int:
    print(subprocess.run(["lscpu"], capture_output=True, text=True).stdout, flush=True)
    print(subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True).stdout, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        for extra, tag in (([], "base"), (["--split-compile=0"], "split"),
                           (["--split-compile=0", "-Xptxas", "--split-compile=0"], "split_ptxas")):
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as ex:
                for row in ex.map(lambda s: one(s, extra, tag, out), SOURCES):
                    print(row, flush=True)
            print(f"[{tag}] all sources at once: wall_s={time.perf_counter() - t0:.2f}", flush=True)
        for extra, tag in (([], "alone_base"), (["--split-compile=0"], "alone_split")):
            print(one(SOURCES[-1], extra, tag, out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
