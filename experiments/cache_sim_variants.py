#!/usr/bin/env python3
"""Time variants of the cache_sim programs against each other on one card.

    python3 experiments/cache_sim_variants.py [--repeats 3] [--sass PATH] [--only heap|placement|split]

Each variant is ``src/repro_torch/kernels/cache_sim/csrc/cache_sim.cu`` (and
its headers) with a few lines replaced, built by ``nvcc`` into
``build/cache_sim_variants/`` (all builds at once). Every variant is held to
the plain version (exact, S = 4, T = 3,000) on the timed cases' shapes; then
each is timed with CUDA events around ``cache_sim_cuda`` at S = 12, T =
100,000, in turns (each variant, then each again in reverse order). Variants:

* ``kernel``: the source as it is (the heap and each row behind one pointer
  chosen at the start).
* ``per_access_test``: each heap access tests whether its slot lies in shared
  or in device memory, as the first version of the design did (its heap
  split across the two).
* ``no_look_ahead``: the step loads its own id's slot and count instead of
  taking them from the step before.
* ``lfu_only``: the kind a compile-time constant (lfu; timed on lfu only).
* ``quaternary``: a 4-ary heap (half the levels, four children a level).

Then the placements of the programs as they are (no patched source; the
wrapper's plan is replaced), each held to the plain version the same way and
timed in turns at S = 12, T = 100,000:

* arc, ``shared`` (``arc_plan``'s choice where N <= 25,827: its tags and
  links in shared memory) against ``device`` (both in device memory, as the
  plan has them past that N), at the paper's N = 10,000 and 21,544;
* tinylfu, ``sketch_first`` (``heap_plan``'s order: the sketch joins the heap
  before the rows) against ``rows_first`` (a plan with the rows first), at
  the three cases of the paper's grid where the order decides which of the
  two lies in shared memory (N = 10,000, cap 2,500; N = 21,544, cap 1,183 and
  1,961), and at the measured case (N = 100,000, cap 2,000: both orders
  place the sketch).

Last, the L1/shared split of the one-warp programs (lfu through
``cache_sim.cu``, tinylfu, arc): ``default`` (the CUDA runtime's choice for a kernel
with dynamic shared memory) against ``max_l1`` (the sources with a preference
for the most L1 that leaves the block its shared memory,
``cudaSharedmemCarveoutMaxL1``),
checked and timed in turns at the measured case and one that fits shared
memory.

With ``--sass PATH`` the SASS of the source as it is goes to PATH
(``cuobjdump``). ``--only`` runs one of the three parts. Needs a CUDA card;
prints one line a result and exits non-zero on a failed build or check.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import zipf  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cache_sim import cache_sim as kernel  # noqa: E402

OUT = ROOT / "build" / "cache_sim_variants"
SOURCE = kernel.PROGRAMS["cache_sim"].source
HEADER = "cache_sim_common.cuh"
QUATERNARY_DOWN = '''    for (;;) {
      const int first = 4 * i + 1;
      if (first >= size) break;
      int c = first;
      unsigned long long ce = slot[first];
      const int last = min(first + 4, size);
#pragma unroll 3
      for (int j = first + 1; j < last; ++j) {
        const unsigned long long cj = slot[j];
        if (cj < ce) {
          ce = cj;
          c = j;
        }
      }
      if (e < ce) break;
      put(i, ce);
      i = c;
    }
    put(i, e);'''
BINARY_DOWN = '''    for (;;) {
      int c = 2 * i + 1;
      if (c >= size) break;
      unsigned long long ce = slot[c];
      if (c + 1 < size) {
        const unsigned long long c2 = slot[c + 1];
        if (c2 < ce) {
          ce = c2;
          ++c;
        }
      }
      if (e < ce) break;
      put(i, ce);
      i = c;
    }
    put(i, e);'''
#: name: (replacements in cache_sim.cu, replacements in the common header)
VARIANTS = {
    "kernel": ([], []),
    "no_look_ahead": ([("      const int px = heap.watch_pos;\n      int fx = freq_ahead;\n",
                        "      const int px = pos[x];\n      int fx = freq[x];\n")], []),
    "per_access_test": ([("    ResidentHeap heap{slots, layout.shared_slots,",
                          "    ResidentHeap heap{{slots, device, layout.shared_slots}, layout.shared_slots,")], [
        ("  unsigned long long* slot;    // shared memory, or `device` once the heap has moved there\n",
         "  struct Slots {\n    unsigned long long* shared;\n    unsigned long long* device;\n    int n_shared;\n"
         "    __device__ unsigned long long& operator[](int i) const {\n"
         "      return i < n_shared ? shared[i] : device[i];\n    }\n  } slot;\n"),
        ("      slot = device;\n", "      slot.n_shared = 0;\n")]),
    "lfu_only": ([("  extern __shared__ __align__(16) unsigned char smem[];\n",
                   "  extern __shared__ __align__(16) unsigned char smem[];\n  constexpr int kKind = kLfu;\n"),
                  ("kind == ", "kKind == "), ("kind != ", "kKind != ")], []),
    "quaternary": ([], [(BINARY_DOWN, QUATERNARY_DOWN), ("const int parent = (i - 1) / 2;",
                                                         "const int parent = (i - 1) / 4;")]),
}
#: (kind, N, capacity): the measured case, the grid's smallest, and one whose rows fit shared memory
TIMED = [("lfu", 100_000, 2_000), ("lru", 100_000, 2_000), ("lru", 100, 2), ("lfu", 10_000, 2_500)]
HEAP_PLAN = kernel.heap_plan  # the wrapper's own


def rows_first(spec, size_range=None) -> kernel.HeapPlan:
    """tinylfu's plan with its rows (pos, freq) joining the heap in shared memory before its sketch."""
    plan = HEAP_PLAN(spec, size_range)
    left = kernel.SHARED_BYTES - plan.shared_slots * kernel._SLOT_BYTES
    rows_shared = plan.n_objects * kernel._ROW_BYTES <= left
    left -= plan.n_objects * kernel._ROW_BYTES * rows_shared
    return dataclasses.replace(plan, rows_shared=rows_shared, sketch_shared=plan.sketch_bytes <= left)


#: name: (kind, the wrapper's attributes to replace): arc's and tinylfu's placements
PLACEMENTS = {
    "shared": ("arc", {}),
    "device": ("arc", {"arc_plan": lambda spec: kernel.ArcPlan(False, spec.n_objects)}),
    "sketch_first": ("tinylfu", {}),
    "rows_first": ("tinylfu", {"heap_plan": rows_first}),
}
#: the launch helper's lines that the max_l1 split adds to
MAX_L1 = [("  if (err != cudaSuccess) return err;\n  kernel<<<",
           "  if (err != cudaSuccess) return err;\n"
           "  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,\n"
           "                             cudaSharedmemCarveoutMaxL1);\n"
           "  if (err != cudaSuccess) return err;\n  kernel<<<")]
#: (kind, N, capacity) of the split's timings
SPLIT = [("lfu", 100_000, 2_000), ("lru", 100, 2), ("tinylfu", 100_000, 2_000), ("tinylfu", 10_000, 2_500),
         ("arc", 100_000, 2_000), ("arc", 10_000, 200)]
#: (kind, N, capacity) of the placement timings
PLACED = [("arc", 10_000, 200), ("arc", 21_544, 1_183),
          ("tinylfu", 10_000, 2_500), ("tinylfu", 21_544, 1_183), ("tinylfu", 21_544, 1_961),
          ("tinylfu", 100_000, 2_000)]


def patch(text: str, reps, what: str) -> str:
    for old, new in reps:
        if old not in text:
            raise RuntimeError(f"{what}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def build_patched(program: str, name: str, src_reps, header_reps) -> _build.Library:
    """``program``'s library from a copy of its source and headers with ``name``'s
    replacements, its entry bound."""
    prog = kernel.PROGRAMS[program]
    out = OUT / f"{prog.library_name}_{name}"
    out.mkdir(parents=True, exist_ok=True)
    for header in prog.source.parent.glob("*.cuh"):
        text = header.read_text()
        (out / header.name).write_text(patch(text, header_reps, name) if header.name == HEADER else text)
    (out / prog.source.name).write_text(patch(prog.source.read_text(), src_reps, name))
    lib = _build.build(f"{prog.library_name}_{name}", [out / prog.source.name])
    entry = getattr(lib.lib, prog.entry)
    entry.argtypes = list(prog.argtypes)
    entry.restype = ctypes.c_int
    lib.lib.cache_sim_error_string.argtypes = [ctypes.c_int]
    lib.lib.cache_sim_error_string.restype = ctypes.c_char_p
    return lib


def build(name: str) -> _build.Library:
    """The heap variant's library, from a patched copy of cache_sim.cu and its headers."""
    return build_patched("cache_sim", name, *VARIANTS[name])


LIBRARY = kernel.library  # the wrapper's own: each program from its source


def use(lib: _build.Library) -> None:
    kernel.library = lambda program="cache_sim", lib=lib: lib


@contextlib.contextmanager
def swapped(library, attrs: dict):
    """The wrapper with ``library`` as its library loader and ``attrs`` replaced."""
    saved = {attr: getattr(kernel, attr) for attr in attrs}
    kernel.library = library
    for attr, value in attrs.items():
        setattr(kernel, attr, value)
    try:
        yield
    finally:
        kernel.library = LIBRARY
        for attr, value in saved.items():
            setattr(kernel, attr, value)


def check_and_time(part: str, kind: str, n: int, cap: int, variants: dict, repeats: int, smi: str) -> bool:
    """Each variant (name: (library loader, wrapper attributes)) against the plain version
    (S = 4, T = 3,000), then timed in turns at S = 12, T = 100,000."""
    kw = dict(kind=kind, n_objects=n, capacity=cap)
    traces = torch.as_tensor(zipf.sample_traces(n, 4, 3_000, seed=1), device="cuda")
    want = kernel.cache_sim_plain(traces, **kw)
    where = {}
    for name, variant in variants.items():
        with swapped(*variant):
            where[name] = placement_text(kind, n, cap)
            got = kernel.cache_sim_cuda(traces, **kw)
        if not all(torch.equal(got[k], want[k]) for k in want):
            print(f"[check] {name} {kind} N={n} cap={cap}: differs from the plain version", flush=True)
            return False
    print(f"[check {part}] {kind} N={n} cap={cap} every variant == plain: {where}", flush=True)
    traces = torch.as_tensor(zipf.sample_traces(n, 12, 100_000, seed=0), device="cuda")
    names = list(variants)
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            with swapped(*variants[name]):
                times[name].append(events_ms(lambda: kernel.cache_sim_cuda(traces, **kw), repeats))
    print(f"[time {part}] {kind} N={n} cap={cap} S=12 T=100000 ms: "
          + " ".join(f"{name}={t}" for name, t in times.items()) + f" card={smi!r}", flush=True)
    return True


def placement_text(kind: str, n: int, cap: int) -> str:
    spec = kernel.spec_of(kind, n, cap)
    if kind == "arc":
        plan = kernel.arc_plan(spec)
        return f"shared={plan.shared}"
    plan = kernel.heap_plan(spec)
    return f"heap_slots={plan.slots} sketch_shared={plan.sketch_shared} rows_shared={plan.rows_shared}"


def time_placements(repeats: int, smi: str) -> int:
    """arc's and tinylfu's placements, each checked, then timed in turns."""
    for kind, n, cap in PLACED:
        variants = {name: (LIBRARY, attrs) for name, (k, attrs) in PLACEMENTS.items() if k == kind}
        if not check_and_time("placement", kind, n, cap, variants, repeats, smi):
            return 1
    return 0


def time_split(repeats: int, smi: str) -> int:
    """Each program with the CUDA runtime's default L1/shared split and with max_l1, checked, then timed in turns."""
    programs = sorted({kernel.PROGRAM_OF[kind] for kind, _, _ in SPLIT})
    with concurrent.futures.ThreadPoolExecutor(len(programs)) as pool:
        max_l1 = dict(zip(programs, pool.map(lambda p: build_patched(p, "max_l1", [], MAX_L1), programs)))
    for kind, n, cap in SPLIT:
        lib = max_l1[kernel.PROGRAM_OF[kind]]
        variants = {"default": (LIBRARY, {}), "max_l1": (lambda program, lib=lib: lib, {})}
        if not check_and_time("split", kind, n, cap, variants, repeats, smi):
            return 1
    return 0


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
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--sass", type=Path)
    parser.add_argument("--only", choices=("heap", "placement", "split"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    if args.only == "placement":
        return time_placements(args.repeats, smi)
    if args.only == "split":
        return time_split(args.repeats, smi)
    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    print(f"[build] variants={list(libs)} elapsed_s={time.perf_counter() - t0:.1f}", flush=True)
    for name, lib in libs.items():
        usage = [line.split(":", 1)[1].strip() for line in lib.ptxas if "Used" in line]
        print(f"[build] {name} ptxas={usage}", flush=True)
    if args.sass:
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([cuobjdump, "--dump-sass", str(libs["kernel"].path)], capture_output=True,
                              text=True, check=True).stdout
        args.sass.parent.mkdir(parents=True, exist_ok=True)
        args.sass.write_text(sass)
        print(f"[sass] {args.sass} lines={len(sass.splitlines())}", flush=True)

    for kind, n, cap in TIMED:
        traces = torch.as_tensor(zipf.sample_traces(n, 4, 3_000, seed=1), device="cuda")
        kw = dict(kind=kind, n_objects=n, capacity=cap)
        want = kernel.cache_sim_plain(traces, **kw)
        for name, lib in libs.items():
            if name == "lfu_only" and kind != "lfu":
                continue
            use(lib)
            got = kernel.cache_sim_cuda(traces, **kw)
            if not all(torch.equal(got[k], want[k]) for k in want):
                print(f"[check] {name} {kind} N={n} cap={cap}: differs from the plain version", flush=True)
                return 1
        print(f"[check] {kind} N={n} cap={cap} every variant == plain", flush=True)

    for kind, n, cap in TIMED:
        traces = torch.as_tensor(zipf.sample_traces(n, 12, 100_000, seed=0), device="cuda")
        kw = dict(kind=kind, n_objects=n, capacity=cap)
        names = [name for name in libs if name != "lfu_only" or kind == "lfu"]
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                use(libs[name])
                times[name].append(events_ms(lambda: kernel.cache_sim_cuda(traces, **kw), args.repeats))
        print(f"[time] {kind} N={n} cap={cap} S=12 T=100000 ms: "
              + " ".join(f"{name}={t}" for name, t in times.items()) + f" card={smi!r}", flush=True)
    if args.only == "heap":
        return 0
    return time_placements(args.repeats, smi) or time_split(args.repeats, smi)


if __name__ == "__main__":
    sys.exit(main())
