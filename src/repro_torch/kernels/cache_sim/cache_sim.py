"""The cache_sim kernel's wrapper and its plain PyTorch version.

``cache_sim_cuda`` launches the hand-written CUDA programs in ``csrc/`` (the
counterparts of the programs of the reference's ``cache_sim_pallas``) on a
CUDA tensor; ``cache_sim_plain`` computes the same contract with
:mod:`repro_torch.core.torch_cache`. Both return a dict:

* hits:     ``(S,)``   int32 — total hits per sample (CHR = hits / T);
* freq:     ``(S, N)`` int32 — final frequency table (lru: last-access stamps
  ``t + 1``, 0 for never requested; arc: every tracked id's stamp ``t``,
  ghosts included; wlfu: counts in the last ``window``);
* in_cache: ``(S, N)`` bool  — final cache contents;
* inserts:  ``(S,)``   int32 — insertions per sample (evictions = inserts -
  final occupancy), the counterpart of the reference simulator's
  ``state["inserts"]``; ``ops.cache_sim`` drops it, as the reference kernel
  has no such output;
* hit_bytes: ``(S,)`` int64 — a size-aware run's bytes of the requests that
  hit;
* dir_size: ``(S,)`` int32 — arc's ids with a list tag (residents and
  ghosts);
* argmins:  ``(S,)`` int32 — from the kernel only: arc's list-LRU searches;
* series:   ``(S, n_windows, N_METRICS)`` int32, or ``(S, n_windows, G,
  N_METRICS)`` with ``n_groups = G`` — only with ``telemetry_window = W``:
  the reference's windowed telemetry (``telemetry.spec.METRICS``), the fourth
  output of ``ops.cache_sim``. Its byte columns use the request's size in a
  size-aware run and 1 otherwise, as the reference kernel's.

Each kind runs one of six programs, each an entry point of a CUDA source:
``cache_sim`` (lru, lfu, plfu, plfua), ``cache_sim/wlfu``,
``cache_sim/tinylfu`` (with or without the doorkeeper),
``cache_sim/plfua_dyn``, ``cache_sim/sized`` (gdsf, and lru/lfu/plfu/plfua/
gdsf under a byte budget), ``cache_sim/plfua_dyn_bytes`` (plfua_dyn under a
byte budget, from the same source as ``cache_sim/plfua_dyn``) and
``cache_sim/arc``. Byte mode takes an ``(N,)`` int32 size row shared by the
samples (``None`` = unit sizes); as in the reference kernel, wlfu, tinylfu
and arc do not run under a byte budget, and kinds that are not size-aware
ignore ``sizes``. Every program records telemetry when asked
(``telemetry_window``, and per tenant group with ``n_groups`` and an ``(N,)``
``groups`` row of values in ``[0, n_groups)``), as a second and third
instance of its kernel (``csrc/telemetry.cuh``): :func:`instance_of` names
them, and ``LAUNCHES`` counts each instance's launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from repro_torch.core import sketch, torch_cache
from repro_torch.kernels import _build
from repro_torch.telemetry import spec as telemetry_spec

#: kinds this kernel runs (the reference's kernel runs every registry kind)
KERNEL_KINDS = torch_cache.PORTED_KINDS
_KIND_CODE = {"lru": 0, "lfu": 1, "plfu": 2, "plfua": 3, "gdsf": 4}
_CSRC = Path(__file__).parent / "csrc"
_I32_MAX = torch.iinfo(torch.int32).max
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
#: the (hits, freq, in_cache, inserts) outputs every program returns
OUTPUTS = ("hits", "freq", "in_cache", "inserts")


@dataclasses.dataclass(frozen=True)
class Program:
    """One CUDA program of the kernel: its source, C entry point and the
    entry's argument types (the trailing stream pointer included)."""

    name: str
    source: Path
    entry: str
    argtypes: tuple

    @property
    def library_name(self) -> str:
        """Programs from one source share its library."""
        return self.source.stem


# every entry ends with the telemetry's three pointers (series, groups, resident counts)
# among its pointers and two ints (window, n_groups) before the device and the stream
PROGRAMS = {
    p.name: p
    for p in (
        Program("cache_sim", _CSRC / "cache_sim.cu", "cache_sim_launch",
                (_PTR,) * 9 + (_INT,) * 12 + (_PTR,)),
        Program("cache_sim/wlfu", _CSRC / "wlfu.cu", "wlfu_launch",
                (_PTR,) * 10 + (_INT,) * 11 + (_PTR,)),
        Program("cache_sim/tinylfu", _CSRC / "tinylfu.cu", "tinylfu_launch",
                (_PTR,) * 12 + (_INT,) * 14 + (_PTR,)),
        Program("cache_sim/plfua_dyn", _CSRC / "plfua_dyn.cu", "plfua_dyn_launch",
                (_PTR,) * 13 + (_INT,) * 15 + (_PTR,)),
        Program("cache_sim/plfua_dyn_bytes", _CSRC / "plfua_dyn.cu", "plfua_dyn_bytes_launch",
                (_PTR,) * 15 + (_INT,) * 17 + (_PTR,)),
        Program("cache_sim/sized", _CSRC / "sized.cu", "sized_launch",
                (_PTR,) * 12 + (_INT,) * 14 + (_PTR,)),
        Program("cache_sim/arc", _CSRC / "arc.cu", "arc_launch",
                (_PTR,) * 11 + (_INT,) * 8 + (_PTR,)),
    )
}
#: the program that runs each kind in object-count mode
PROGRAM_OF = {
    **{kind: "cache_sim" for kind in ("lru", "lfu", "plfu", "plfua")},
    "wlfu": "cache_sim/wlfu",
    "tinylfu": "cache_sim/tinylfu",
    "plfua_dyn": "cache_sim/plfua_dyn",
    "gdsf": "cache_sim/sized",
    "arc": "cache_sim/arc",
}
#: the program that runs each kind under a byte budget
BYTES_PROGRAM_OF = {
    **{kind: "cache_sim/sized" for kind in ("lru", "lfu", "plfu", "plfua", "gdsf")},
    "plfua_dyn": "cache_sim/plfua_dyn_bytes",
}
#: kinds the kernel runs under a byte budget: the reference kernel's
BYTE_CAPABLE_KINDS = tuple(k for k in KERNEL_KINDS if k in BYTES_PROGRAM_OF)

#: the programs whose victims come from a heap of the residents: every program but arc, which
#: keeps its lists in stamp order
HEAP_PROGRAMS = tuple(p for p in PROGRAMS if p != "cache_sim/arc")
#: the programs with a count-min sketch (and tinylfu's doorkeeper) beside the heap
SKETCH_PROGRAMS = ("cache_sim/tinylfu", "cache_sim/plfua_dyn", "cache_sim/plfua_dyn_bytes")
#: shared memory a block can have on Hopper (cudaDevAttrMaxSharedMemoryPerBlockOptin)
SHARED_BYTES = 232_448
_SLOT_BYTES = 8  # a heap slot: (key, id) packed in 64 bits
_ROW_BYTES = 8  # an id's entries in the rows: its slot (pos) and its count (freq)
#: plfua_dyn's static shared memory: block_reduce's int a warp of its 256 threads
_REDUCE_BYTES = 32


def hot_mask_bytes(n_objects: int) -> int:
    """plfua_dyn's hot mask: a byte an id, in whole warps of 32 bytes."""
    return -(-n_objects // 32) * 32


@dataclasses.dataclass(frozen=True)
class HeapPlan:
    """Where a heap program keeps its heap and rows, per sample: ``slots``
    bounds the ids the cache can ever hold; the heap lies in shared memory,
    which holds ``shared_slots`` slots, and a heap that outgrows them moves
    to an ``(S, slots)`` device buffer (none where every slot fits); with
    ``rows_shared`` the per-id rows (pos, freq) lie in shared memory beside
    the slots, else in ``(S, N)`` device buffers; tinylfu's and plfua_dyn's
    sketch (``sketch_bytes``: 4 x width int32, and tinylfu's byte a
    doorkeeper bit) lies there too with ``sketch_shared``, and plfua_dyn's
    hot mask (``hot_bytes``) with ``hot_shared``, else each in device
    buffers."""

    slots: int
    shared_slots: int
    rows_shared: bool
    n_objects: int
    sketch_bytes: int = 0
    sketch_shared: bool = False
    hot_bytes: int = 0
    hot_shared: bool = False

    @property
    def shared_bytes(self) -> int:
        """The block's dynamic shared memory (the kernel's own count)."""
        return (self.shared_slots * _SLOT_BYTES + self.rows_shared * self.n_objects * _ROW_BYTES
                + self.sketch_shared * self.sketch_bytes + self.hot_shared * self.hot_bytes)

    @property
    def can_move(self) -> bool:
        """Whether the heap can outgrow shared memory (and needs the device buffer)."""
        return self.slots > self.shared_slots


def heap_plan(spec: torch_cache.PolicySpec, size_range: tuple[int, int] | None = None) -> HeapPlan:
    """The heap program's layout for ``spec`` (``size_range``: the smallest
    and largest size of a byte-mode run's row). The slots bound the cached
    ids exactly: lru's stamps and the counts stay below INT_MAX, so the
    cache holds ``max(capacity, 1)`` ids (one with ``capacity`` <= 0), or in
    byte mode at most ``cap_bytes // min(sizes)`` unless ``cap_bytes +
    max(sizes)`` can wrap; gdsf's scores can reach INT_MAX, where the
    reference's victim may be an id that is not cached and the cache may
    outgrow its count, so gdsf takes N.

    wlfu, tinylfu and plfua_dyn take ``max(capacity, 1)`` too. wlfu's and
    plfua_dyn's window counts and counts stay below INT_MAX, as lfu's do.
    tinylfu inserts without a victim only while its count is below the
    capacity, and a won duel evicts the heap's top as it inserts x. The top
    is cached whenever the heap holds an id (counts stay below INT_MAX), so
    an insert adds an id past the count only into an empty heap, which
    capacity <= 0 alone reaches, once: the count then trails the cache's one
    resident, as the reference's does.

    The heap takes shared memory first; then the sketch (tinylfu's and
    plfua_dyn's), then plfua_dyn's hot mask, then the rows, each where it
    fits beside what is there (the sketch's four counters a request and a
    duel's four loads gain more there than the rows' two loads, which the
    kernel issues a step ahead). A heap that cannot lie in shared memory
    whole (byte mode's slots, gdsf's N) comes after the sketch instead and
    takes what is left, past which it moves to device memory: the heap
    rarely fills such slots, while the sketch takes four read-modify-writes
    a request. plfua_dyn's block keeps ``_REDUCE_BYTES`` of static shared
    memory beside them."""
    n = spec.n_objects
    if spec.kind == "gdsf":
        slots = n
    elif spec.capacity_bytes:
        lo, hi = size_range
        slots = n if spec.capacity_bytes + hi > _I32_MAX else min(n, spec.capacity_bytes // lo)
    else:
        slots = min(n, max(spec.capacity, 1))
    left = SHARED_BYTES - (_REDUCE_BYTES if spec.kind == "plfua_dyn" else 0)
    with_sketch = spec.kind in ("tinylfu", "plfua_dyn")
    sketch_bytes = sketch.DEPTH * spec.effective_sketch_width * 4 + spec.doorkeeper if with_sketch else 0
    heap_first = slots * _SLOT_BYTES <= left  # else the heap comes after the sketch
    sketch_shared = 0 < sketch_bytes <= left - heap_first * slots * _SLOT_BYTES
    left -= sketch_bytes * sketch_shared
    shared_slots = min(slots, left // _SLOT_BYTES)
    left -= shared_slots * _SLOT_BYTES
    hot_bytes = hot_mask_bytes(n) if spec.kind == "plfua_dyn" else 0
    hot_shared = 0 < hot_bytes <= left
    left -= hot_bytes * hot_shared
    return HeapPlan(slots, shared_slots, n * _ROW_BYTES <= left, n, sketch_bytes, sketch_shared, hot_bytes,
                    hot_shared)


@dataclasses.dataclass(frozen=True)
class ArcPlan:
    """Where the arc program keeps its rows, per sample: the tags (a byte an
    id) and the links ((prev, next), 8 B an id, after the tags at an 8-byte
    boundary) lie in shared memory with ``shared``, else in ``(S, N)`` and
    ``(S, N, 2)`` device buffers."""

    shared: bool
    n_objects: int

    @property
    def shared_bytes(self) -> int:
        """The block's dynamic shared memory (the kernel's own count)."""
        return (-(-self.n_objects // 8) * 8 + self.n_objects * 8) * self.shared


def arc_plan(spec: torch_cache.PolicySpec) -> ArcPlan:
    """The arc program's layout for ``spec``: its rows in shared memory where
    they fit (9 B an id: N <= 25,827)."""
    return ArcPlan(ArcPlan(True, spec.n_objects).shared_bytes <= SHARED_BYTES, spec.n_objects)


#: the suffixes of a program's telemetry instances: ungrouped and per tenant group
TELEMETRY_SUFFIXES = ("+telemetry", "+telemetry_grouped")


def instance_of(program: str, telemetry_window: int = 0, n_groups: int = 0) -> str:
    """The kernel instance a launch of ``program`` runs: the program itself
    without telemetry, else its ``+telemetry`` or ``+telemetry_grouped``
    instance."""
    if not telemetry_window:
        return program
    return program + TELEMETRY_SUFFIXES[bool(n_groups)]


#: every kernel instance: each program without telemetry, then with it
INSTANCES = tuple(PROGRAMS) + tuple(p + suffix for suffix in TELEMETRY_SUFFIXES for p in PROGRAMS)
#: kernel launches per instance since import (or since a caller last set them to 0)
LAUNCHES = dict.fromkeys(INSTANCES, 0)


def program_of(kind: str, capacity_bytes: int = 0) -> str:
    """The program that runs ``kind`` (under a byte budget when ``capacity_bytes``)."""
    return BYTES_PROGRAM_OF[kind] if capacity_bytes else PROGRAM_OF[kind]


def library(program: str = "cache_sim") -> _build.Library:
    """Build (at first use) and load one program's library, with its C signatures."""
    prog = PROGRAMS[program]
    built = _build.build(prog.library_name, (prog.source,))
    launch = getattr(built.lib, prog.entry)
    launch.argtypes = list(prog.argtypes)
    launch.restype = ctypes.c_int
    built.lib.cache_sim_error_string.argtypes = [ctypes.c_int]
    built.lib.cache_sim_error_string.restype = ctypes.c_char_p
    return built


def _in_range(name: str, value: int, lo: int) -> None:
    if not lo <= value <= _I32_MAX:
        raise ValueError(f"{name} must be in [{lo}, {_I32_MAX}], got {value}")


def spec_of(kind: str, n_objects: int, capacity: int, hot_size: int = 0, window: int = 0,
            refresh: int = 0, sketch_width: int = 0, doorkeeper: int = 0, capacity_bytes: int = 0,
            max_victims: int = 0) -> torch_cache.PolicySpec:
    """Validate a call's options like the reference kernel's wrapper
    (``cache_sim_pallas``) and return them as a spec: its ``effective_*``
    values are the options the kernel runs with (each 0 takes the
    reference's default; a kind ignores the options not its own)."""
    if kind not in KERNEL_KINDS:
        raise ValueError(f"kind={kind!r} not in {KERNEL_KINDS}")
    _in_range("n_objects", n_objects, 1)
    _in_range("capacity", capacity, -_I32_MAX)
    for name, value in (("hot_size", hot_size), ("window", window), ("refresh", refresh),
                        ("sketch_width", sketch_width), ("doorkeeper", doorkeeper),
                        ("capacity_bytes", capacity_bytes), ("max_victims", max_victims)):
        _in_range(name, value, 0)
    if capacity_bytes and kind not in BYTE_CAPABLE_KINDS:
        raise ValueError(
            f"byte-capacity mode is not supported for kind={kind!r} by the cache_sim "
            f"kernel (supported: {BYTE_CAPABLE_KINDS}); use torch_cache"
        )
    # PolicySpec raises the reference's errors for wlfu's window, the
    # doorkeeper and max_victims without a byte budget
    return torch_cache.PolicySpec(kind, n_objects, capacity, hot_size=hot_size, window=window,
                                  refresh=refresh, sketch_width=sketch_width, doorkeeper=doorkeeper,
                                  capacity_bytes=capacity_bytes, max_victims=max_victims)


def _check_traces(traces: torch.Tensor, n_objects: int) -> None:
    if not isinstance(traces, torch.Tensor) or traces.ndim != 2:
        raise ValueError("traces must be an (S, T) tensor")
    if traces.dtype != torch.int32:
        raise ValueError(f"traces must be int32, got {traces.dtype}")
    if not traces.is_contiguous():
        raise ValueError("traces must be contiguous")
    if traces.shape[1] >= _I32_MAX:
        raise ValueError("trace length must stay below 2**31 - 1 (lru stamps are t + 1)")
    if traces.numel():
        # the kernel indexes state by id; an id outside [0, n) would write out of bounds
        lo, hi = torch.aminmax(traces)
        if int(lo) < 0 or int(hi) >= n_objects:
            raise ValueError(f"trace ids must lie in [0, {n_objects}), got [{int(lo)}, {int(hi)}]")


def _sizes_row(spec: torch_cache.PolicySpec, sizes, device) -> tuple[torch.Tensor | None, tuple[int, int] | None]:
    """The ``(N,)`` int32 size row a size-aware spec runs with (unit sizes for
    ``None``), contiguous on ``device``, and its (smallest, largest) size;
    ``(None, None)`` for a spec that ignores sizes, as the reference kernel
    ignores them. Raises on a wrong shape and on a size below 1 (gdsf
    divides by it)."""
    if not spec.size_aware:
        return None, None
    n = spec.n_objects
    if sizes is None:
        return torch.ones(n, dtype=torch.int32, device=device), (1, 1)
    sizes = torch.as_tensor(sizes, dtype=torch.int32, device=device).contiguous()
    if tuple(sizes.shape) != (n,):
        raise ValueError(f"sizes must have shape ({n},), got {tuple(sizes.shape)}")
    lo, hi = (int(v) for v in torch.aminmax(sizes))
    if lo < 1:
        raise ValueError("sizes must be >= 1")
    return sizes, (lo, hi)


def telemetry_options(n_objects: int, telemetry_window: int = 0, n_groups: int = 0, groups=None,
                      device=None):
    """Validate a call's telemetry options as the reference kernel's wrapper
    does (``telemetry_window >= 0``; ``n_groups`` needs ``telemetry_window``
    and ``groups``) and return ``(TelemetrySpec or None, the (N,) int32
    group row on device or None)``. The kernel indexes its series by group,
    so the row must have shape ``(N,)`` and values in ``[0, n_groups)``."""
    if telemetry_window < 0:
        raise ValueError(f"telemetry_window must be >= 0, got {telemetry_window}")
    if n_groups < 0:
        raise ValueError(f"n_groups must be >= 0, got {n_groups}")
    if n_groups and not telemetry_window:
        raise ValueError("n_groups is a telemetry option: set telemetry_window")
    if n_groups and groups is None:
        raise ValueError("n_groups > 0 requires a groups catalogue")
    _in_range("telemetry_window", telemetry_window, 0)
    _in_range("n_groups", n_groups, 0)
    if not telemetry_window:
        return None, None
    telemetry = telemetry_spec.TelemetrySpec(telemetry_window, n_groups)
    if not n_groups:
        return telemetry, None
    groups = torch.as_tensor(groups, dtype=torch.int32, device=device).contiguous()
    if tuple(groups.shape) != (n_objects,):
        raise ValueError(f"groups must have shape ({n_objects},), got {tuple(groups.shape)}")
    lo, hi = torch.aminmax(groups)
    if int(lo) < 0 or int(hi) >= n_groups:
        raise ValueError(f"groups must lie in [0, {n_groups}), got [{int(lo)}, {int(hi)}]")
    return telemetry, groups


def _derived_inserts(traces: torch.Tensor, hits: torch.Tensor, spec: torch_cache.PolicySpec) -> torch.Tensor:
    """The object-count kinds without a sketch: every admitted miss inserts
    (arc's too: a cold miss into T1, a ghost hit into T2), and only plfua
    refuses misses (ids at or above its hot-set size), so inserts follow
    from the hits."""
    admitted = (traces < spec.effective_hot).sum(dim=1) if spec.kind == "plfua" else traces.shape[1]
    return (admitted - hits).to(torch.int32)


def _launch_args(spec: torch_cache.PolicySpec, traces: torch.Tensor, sizes: torch.Tensor | None,
                 telemetry: telemetry_spec.TelemetrySpec | None = None, groups: torch.Tensor | None = None,
                 size_range: tuple[int, int] | None = None):
    """The kind's program, its outputs (zeroed) with the scratch it needs, and
    the C entry's arguments before the device and the stream, on the tensors'
    own device. The outputs also hold (under ``_`` names) every tensor whose
    pointer the arguments carry besides ``traces``: the sizes and group rows
    and the scratch (the heap programs' slot row and device heap, arc's
    tags and links, sketch rows, bloom, hot mask, estimates, per-group
    resident counts), so that none is freed before the launch; once it has
    been queued the caching allocator hands them out again only in stream
    order, after it. With ``telemetry`` the outputs gain the zeroed
    ``series``. A heap program lays out its heap by :func:`heap_plan`
    (``size_range`` is ``_sizes_row``'s), arc its rows by :func:`arc_plan`."""
    s, t = traces.shape
    n = spec.n_objects
    dev = traces.device
    zeros = lambda *shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype, device=dev)
    program = program_of(spec.kind, spec.capacity_bytes)
    outs = dict(hits=zeros(s), freq=zeros(s, n), in_cache=zeros(s, n, dtype=torch.bool), inserts=zeros(s),
                _sizes=sizes, _groups=groups)
    ptr = lambda *tensors: [0 if a is None else a.data_ptr() for a in tensors]
    hits, freq, in_cache, inserts = (outs[k] for k in OUTPUTS)
    window, n_groups = (telemetry.window, telemetry.n_groups) if telemetry is not None else (0, 0)
    if telemetry is not None:
        layout = (telemetry.n_windows(t),) + ((n_groups,) if n_groups else ()) + (telemetry_spec.N_METRICS,)
        outs["series"] = zeros(s, *layout)
        outs["_resident"] = zeros(s, n_groups) if n_groups else None
    tel = ptr(outs.get("series"), groups, outs.get("_resident"))
    dims = [s, t, n]
    if program in HEAP_PROGRAMS:
        plan = heap_plan(spec, size_range)
        outs["_pos"] = None if plan.rows_shared else torch.empty((s, n), dtype=torch.int32, device=dev)
        outs["_heap"] = torch.empty((s, plan.slots), dtype=torch.int64, device=dev) if plan.can_move else None
        heap = ptr(outs["_pos"], outs["_heap"])
        layout = [plan.slots, plan.shared_slots, int(plan.rows_shared)]
        if program in SKETCH_PROGRAMS:
            layout.append(int(plan.sketch_shared))
        if program in ("cache_sim/plfua_dyn", "cache_sim/plfua_dyn_bytes"):
            layout.append(int(plan.hot_shared))
        layout += [window, n_groups]
    if program == "cache_sim":
        return program, outs, ptr(traces, hits, freq, in_cache) + heap + tel + dims + [
            _KIND_CODE[spec.kind], spec.capacity, spec.effective_hot] + layout
    if sizes is not None:
        outs["hit_bytes"] = zeros(s, dtype=torch.int64)
    if program == "cache_sim/sized":
        return program, outs, ptr(traces, sizes, hits, inserts, outs["hit_bytes"], freq,
                                  in_cache) + heap + tel + dims + [
            _KIND_CODE[spec.kind], spec.capacity, spec.effective_hot, spec.capacity_bytes,
            spec.effective_max_victims if spec.capacity_bytes else 0] + layout
    if program == "cache_sim/arc":
        plan = arc_plan(spec)
        device_rows = not plan.shared
        outs.update(dir_size=zeros(s), argmins=zeros(s),
                    _tags=torch.empty((s, n), dtype=torch.uint8, device=dev) if device_rows else None,
                    _links=torch.empty((s, n, 2), dtype=torch.int32, device=dev) if device_rows else None)
        return program, outs, ptr(traces, hits, outs["dir_size"], outs["argmins"], freq, in_cache,
                                  outs["_tags"], outs["_links"]) + tel + dims + [
            spec.capacity, int(plan.shared), window, n_groups]
    if program == "cache_sim/wlfu":
        return program, outs, ptr(traces, hits, inserts, freq, in_cache) + heap + tel + dims + [
            spec.capacity, spec.window] + layout
    width = spec.effective_sketch_width
    outs["_rows"] = None if plan.sketch_shared else zeros(s, sketch.DEPTH, width)
    if program == "cache_sim/tinylfu":
        with_bloom = not plan.sketch_shared and spec.doorkeeper
        outs["_bloom"] = zeros(s, spec.doorkeeper, dtype=torch.uint8) if with_bloom else None
        return program, outs, ptr(traces, hits, inserts, freq, in_cache) + heap + ptr(
            outs["_rows"], outs["_bloom"]) + tel + dims + [
            spec.capacity, spec.effective_window, width, spec.doorkeeper] + layout
    outs["_hot"] = None if plan.hot_shared else torch.empty((s, plan.hot_bytes), dtype=torch.uint8, device=dev)
    outs["_est"] = torch.empty((s, n), dtype=torch.int32, device=dev)
    scratch = heap + ptr(outs["_rows"], outs["_hot"], outs["_est"])
    options = [spec.capacity, spec.effective_hot, spec.effective_refresh, width]
    if program == "cache_sim/plfua_dyn":
        return program, outs, ptr(traces, hits, inserts, freq, in_cache) + scratch + tel + dims + options + layout
    return program, outs, ptr(traces, sizes, hits, inserts, outs["hit_bytes"], freq,
                              in_cache) + scratch + tel + dims + options + [
        spec.capacity_bytes, spec.effective_max_victims] + layout


def cache_sim_cuda(traces: torch.Tensor, *, kind: str, n_objects: int, capacity: int, hot_size: int = 0,
                   window: int = 0, refresh: int = 0, sketch_width: int = 0, doorkeeper: int = 0,
                   capacity_bytes: int = 0, max_victims: int = 0, sizes=None, telemetry_window: int = 0,
                   n_groups: int = 0, groups=None) -> dict:
    """Launch the kind's program on ``traces`` ((S, T) int32, contiguous, on
    a CUDA device) and return its outputs by name: ``hits``, ``freq``,
    ``in_cache``, ``inserts``, a size-aware run's ``hit_bytes``, arc's
    ``dir_size`` and ``argmins``, and with ``telemetry_window`` the
    ``series``. Raises on anything the kernel does not take, and if the
    launch fails."""
    if not isinstance(traces, torch.Tensor) or not traces.is_cuda:
        raise ValueError("cache_sim_cuda takes a CUDA tensor; cache_sim_plain is the CPU version")
    spec = spec_of(kind, n_objects, capacity, hot_size, window, refresh, sketch_width, doorkeeper,
                   capacity_bytes, max_victims)
    _check_traces(traces, n_objects)
    dev = traces.device
    telemetry, groups = telemetry_options(n_objects, telemetry_window, n_groups, groups, dev)
    sizes, size_range = _sizes_row(spec, sizes, dev)
    program, outs, args = _launch_args(spec, traces, sizes, telemetry, groups, size_range)
    if traces.shape[0]:
        # the arguments' tensors live in outs until the launch is queued
        built = library(program)
        err = getattr(built.lib, PROGRAMS[program].entry)(
            *args,
            dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            msg = built.lib.cache_sim_error_string(err).decode()
            raise RuntimeError(f"{program} kernel launch failed: CUDA error {err} ({msg})")
        LAUNCHES[instance_of(program, telemetry_window, n_groups)] += 1
    if program in ("cache_sim", "cache_sim/arc"):
        outs["inserts"] = _derived_inserts(traces, outs["hits"], spec)
    return {k: v for k, v in outs.items() if not k.startswith("_")}


def cache_sim_plain(traces: torch.Tensor, *, kind: str, n_objects: int, capacity: int, hot_size: int = 0,
                    window: int = 0, refresh: int = 0, sketch_width: int = 0, doorkeeper: int = 0,
                    capacity_bytes: int = 0, max_victims: int = 0, sizes=None, telemetry_window: int = 0,
                    n_groups: int = 0, groups=None) -> dict:
    """The kernel's contract computed with ``torch_cache`` on the tensor's own
    device: the CPU path of ``ops.cache_sim``, and the yardstick the kernel is
    held to on the card. The same names as :func:`cache_sim_cuda`
    (arc's ``dir_size`` from the final tags; no ``argmins``: the plain
    version runs every search)."""
    spec = spec_of(kind, n_objects, capacity, hot_size, window, refresh, sketch_width, doorkeeper,
                   capacity_bytes, max_victims)
    _check_traces(traces, n_objects)
    telemetry, groups = telemetry_options(n_objects, telemetry_window, n_groups, groups, traces.device)
    sizes, _ = _sizes_row(spec, sizes, traces.device)
    run = torch_cache.simulate_batch(spec, traces, telemetry, sizes=sizes, groups=groups, device=traces.device)
    hit_series, state = run[0], run[1]
    hits = hit_series.sum(dim=1, dtype=torch.int32)
    if kind == "lru":
        # the scan keeps last-access t (0 is ambiguous); the kernel keeps t + 1, 0 = never
        seen = torch.zeros_like(state["in_cache"]).scatter_(1, traces.long(), True)
        freq = torch.where(seen, state["last"] + 1, 0)
    elif kind == "arc":
        freq = state["stamp"]
    else:
        freq = state["freq"]
    if "inserts" in state:
        inserts = state["inserts"]
    else:
        inserts = _derived_inserts(traces, hits, spec)
    outs = dict(hits=hits, freq=freq.to(torch.int32), in_cache=state["in_cache"], inserts=inserts)
    if sizes is not None:
        outs["hit_bytes"] = torch.where(hit_series, sizes[traces.long()].long(), 0).sum(dim=1)
    if kind == "arc":
        outs["dir_size"] = torch_cache.metadata_entries(spec, state).to(torch.int32)
    if telemetry is not None:
        outs["series"] = run[2]
    return outs

