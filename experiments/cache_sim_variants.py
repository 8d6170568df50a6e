#!/usr/bin/env python3
"""Time variants of the cache_sim programs against each other on one card.

    python3 experiments/cache_sim_variants.py [--repeats 3] [--sass PATH] [--only heap|placement|split|hot]

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
  place the sketch);
* plfua_dyn under the byte budget, ``sketch_first`` (``heap_plan``: a heap
  that cannot lie in shared memory whole, N slots at these cases, comes after
  the sketch, its shared slots what is left, past which it moves to device
  memory) against ``heap_first`` (the heap's slots take shared memory first,
  leaving the sketch and hot mask in device memory), at N = 100,000, cap
  2,000 (the measured case) and 3,314.

Then the L1/shared split of all seven programs (lfu through ``cache_sim.cu``,
wlfu, tinylfu, plfua_dyn, gdsf and plfua_dyn under the byte budget, arc):
``default`` (the CUDA runtime's choice for a kernel with dynamic shared memory)
against ``max_l1`` (a preference for the most L1 that leaves the block its
shared memory, ``cudaSharedmemCarveoutMaxL1``), each a patched copy of the
sources' launch helper (with the preference added, or taken out, whichever the
source lacks), checked and timed in turns at the measured case and one whose
rows fit shared memory.

Last, plfua_dyn's hot mask: ``bytes`` (the source: a byte an id) against
``bits`` (a patched copy and plan: a bit an id), at two cases where both fit
shared memory beside the same placement of everything else (N = 4,642, cap
1,160; N = 10,000, cap 200) and at the measured case (the bytes in device
memory, the bits in shared memory).

With ``--sass PATH`` the SASS of the source as it is goes to PATH
(``cuobjdump``). ``--only`` runs one of the four parts. Needs a CUDA card;
prints one line a result and exits non-zero on a failed build or check.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import simulate, zipf  # noqa: E402
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


def heap_first(spec, size_range=None) -> kernel.HeapPlan:
    """plfua_dyn's plan with a heap that cannot lie in shared memory whole (byte mode's
    slots) taking all of it first, the sketch and hot mask after it where they fit."""
    plan = HEAP_PLAN(spec, size_range)
    if not plan.can_move:
        return plan
    shared_slots = (kernel.SHARED_BYTES - kernel._REDUCE_BYTES) // kernel._SLOT_BYTES
    left = kernel.SHARED_BYTES - kernel._REDUCE_BYTES - shared_slots * kernel._SLOT_BYTES
    sketch_shared = plan.sketch_bytes <= left
    left -= plan.sketch_bytes * sketch_shared
    return dataclasses.replace(plan, shared_slots=shared_slots, sketch_shared=sketch_shared,
                               hot_shared=plan.hot_bytes <= left)


#: name: (kind, the wrapper's attributes to replace): arc's, tinylfu's and byte-mode plfua_dyn's placements
PLACEMENTS = {
    "shared": ("arc", {}),
    "device": ("arc", {"arc_plan": lambda spec: kernel.ArcPlan(False, spec.n_objects)}),
    "sketch_first": ("tinylfu", {}),
    "rows_first": ("tinylfu", {"heap_plan": rows_first}),
    "sketch_first_bytes": ("plfua_dyn", {}),
    "heap_first": ("plfua_dyn", {"heap_plan": heap_first}),
}
#: the launch helper's preference for L1 (the max_l1 split), before its launch
CARVEOUT = ("  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,\n"
            "                             cudaSharedmemCarveoutMaxL1);\n"
            "  if (err != cudaSuccess) return err;\n")
LAUNCH = "  kernel<<<"
#: (kind, N, capacity, under the byte budget) of the split's timings: each program at the measured
#: case and at one whose rows fit shared memory
SPLIT = [("lfu", 100_000, 2_000, False), ("lfu", 10_000, 200, False), ("wlfu", 100_000, 2_000, False),
         ("wlfu", 10_000, 200, False), ("tinylfu", 100_000, 2_000, False), ("tinylfu", 10_000, 200, False),
         ("plfua_dyn", 100_000, 2_000, False), ("plfua_dyn", 10_000, 200, False), ("gdsf", 100_000, 2_000, True),
         ("gdsf", 10_000, 200, True), ("plfua_dyn", 100_000, 2_000, True), ("plfua_dyn", 10_000, 200, True),
         ("arc", 100_000, 2_000, False), ("arc", 10_000, 200, False)]
#: plfua_dyn's hot mask as a bit an id (32-bit words, written a warp's ballot at a time), in
#: place of the source's byte an id
HOT_BITS = """struct HotMask {
  unsigned char* byte;

  __host__ __device__ static int bytes(int n) { return (n + kWarp - 1) / kWarp * 4; }

  __device__ __forceinline__ bool get(int i) const {
    return (reinterpret_cast<const unsigned*>(byte)[i >> 5] >> (i & 31)) & 1u;
  }

  __device__ __forceinline__ bool set_warp(int base, bool now) const {
    unsigned* word = reinterpret_cast<unsigned*>(byte) + base / kWarp;
    const int lane = threadIdx.x % kWarp;
    const unsigned bits = __ballot_sync(0xffffffffu, now);
    const bool was = (*word >> lane) & 1u;
    __syncwarp();  // every lane's read before lane 0's write
    if (lane == 0) *word = bits;
    return was != now;
  }
};
"""
#: (N, capacity) of the hot mask's timings
HOT_CASES = [(4_642, 1_160), (10_000, 200), (100_000, 2_000)]
#: (kind, N, capacity, under the byte budget) of the placement timings
PLACED = [("arc", 10_000, 200, False), ("arc", 21_544, 1_183, False),
          ("tinylfu", 10_000, 2_500, False), ("tinylfu", 21_544, 1_183, False), ("tinylfu", 21_544, 1_961, False),
          ("tinylfu", 100_000, 2_000, False), ("plfua_dyn", 100_000, 2_000, True), ("plfua_dyn", 100_000, 3_314, True)]


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


def options(kind: str, n: int, cap: int, budget: bool = False) -> dict:
    """A timed call's options: the grid's wlfu window, and the byte benchmark's catalogue and budget."""
    kw = dict(kind=kind, n_objects=n, capacity=cap)
    if kind == "wlfu":
        kw["window"] = simulate.WLFU_WINDOW
    if budget:
        sizes = simulate.bytes_catalogue(n)
        kw.update(sizes=sizes, capacity_bytes=simulate.bytes_budget(sizes, cap))
    return kw


def check_and_time(part: str, kw: dict, variants: dict, repeats: int, smi: str) -> bool:
    """Each variant (name: (library loader, wrapper attributes)) against the plain version
    (S = 4, T = 3,000) on the call ``kw``, then timed in turns at S = 12, T = 100,000."""
    n = kw["n_objects"]
    label = f"{kernel.program_of(kw['kind'], kw.get('capacity_bytes', 0))} {kw['kind']} N={n} cap={kw['capacity']}"
    traces = torch.as_tensor(zipf.sample_traces(n, 4, 3_000, seed=1), device="cuda")
    want = kernel.cache_sim_plain(traces, **kw)
    where = {}
    for name, variant in variants.items():
        with swapped(*variant):
            where[name] = placement_text(kw)
            got = kernel.cache_sim_cuda(traces, **kw)
        if not all(torch.equal(got[k], want[k]) for k in want):
            print(f"[check] {name} {label}: differs from the plain version", flush=True)
            return False
    print(f"[check {part}] {label} every variant == plain: {where}", flush=True)
    traces = torch.as_tensor(zipf.sample_traces(n, 12, 100_000, seed=0), device="cuda")
    names = list(variants)
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            with swapped(*variants[name]):
                times[name].append(events_ms(lambda: kernel.cache_sim_cuda(traces, **kw), repeats))
    print(f"[time {part}] {label} S=12 T=100000 ms: "
          + " ".join(f"{name}={t}" for name, t in times.items()) + f" card={smi!r}", flush=True)
    return True


def placement_text(kw: dict) -> str:
    spec = kernel.spec_of(**{k: v for k, v in kw.items() if k != "sizes"})
    if spec.kind == "arc":
        plan = kernel.arc_plan(spec)
        return f"shared={plan.shared}"
    size_range = (int(kw["sizes"].min()), int(kw["sizes"].max())) if "sizes" in kw else (1, 1)
    plan = kernel.heap_plan(spec, size_range)
    return (f"heap_slots={plan.slots} shared_slots={plan.shared_slots} sketch_shared={plan.sketch_shared} "
            f"hot_shared={plan.hot_shared} hot_bytes={plan.hot_bytes} rows_shared={plan.rows_shared}")


def time_placements(repeats: int, smi: str) -> int:
    """arc's, tinylfu's and byte-mode plfua_dyn's placements, each checked, then timed in turns."""
    for kind, n, cap, budget in PLACED:
        variants = {name: (LIBRARY, attrs) for name, (k, attrs) in PLACEMENTS.items() if k == kind}
        if not check_and_time("placement", options(kind, n, cap, budget), variants, repeats, smi):
            return 1
    return 0


def split_patch(with_l1: bool) -> list:
    """The launch helper's replacements that give it the preference for L1, or take it away."""
    text = (kernel._CSRC / HEADER).read_text()
    if with_l1 and CARVEOUT not in text:
        return [(LAUNCH, CARVEOUT + LAUNCH)]
    if not with_l1 and CARVEOUT in text:
        return [(CARVEOUT, "")]
    return []


def time_split(repeats: int, smi: str) -> int:
    """Each program with the CUDA runtime's default L1/shared split and with max_l1, checked, then timed in turns."""
    programs = sorted({kernel.program_of(kind, budget) for kind, _, _, budget in SPLIT})
    builds = [(p, name, with_l1) for p in programs for name, with_l1 in (("default", False), ("max_l1", True))]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(((p, name) for p, name, _ in builds),
                        pool.map(lambda b: build_patched(b[0], b[1], [], split_patch(b[2])), builds)))
    for kind, n, cap, budget in SPLIT:
        program = kernel.program_of(kind, budget)
        variants = {name: (lambda _program, lib=libs[program, name]: lib, {}) for name in ("default", "max_l1")}
        if not check_and_time("split", options(kind, n, cap, budget), variants, repeats, smi):
            return 1
    return 0


def time_hot(repeats: int, smi: str) -> int:
    """plfua_dyn's hot mask as bytes (the source) and as bits, checked, then timed in turns.
    Both are built as copies and handed to the wrapper alike: the wrapper's own loader hashes
    the sources on every call, which a timing that syncs on the host each call would count."""
    source = kernel.PROGRAMS["cache_sim/plfua_dyn"].source.read_text()
    mask = re.search(r"struct HotMask \{.*?\n\};\n", source, re.S).group(0)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        as_bytes, as_bits = pool.map(lambda args: build_patched("cache_sim/plfua_dyn", *args, []),
                                     (("hot_bytes", []), ("hot_bits", [(mask, HOT_BITS)])))
    variants = {"bytes": (lambda _program: as_bytes, {}),
                "bits": (lambda _program: as_bits, {"hot_mask_bytes": lambda n: -(-n // 32) * 4})}
    for n, cap in HOT_CASES:
        if not check_and_time("hot", options("plfua_dyn", n, cap), variants, repeats, smi):
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
    parser.add_argument("--only", choices=("heap", "placement", "split", "hot"))
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
    if args.only == "hot":
        return time_hot(args.repeats, smi)
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
    return time_placements(args.repeats, smi) or time_split(args.repeats, smi) or time_hot(args.repeats, smi)


if __name__ == "__main__":
    sys.exit(main())
