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
* argmins:  ``(S,)`` int32 — from the kernel only: arc's list-LRU searches.

Each kind runs one of six programs, each an entry point of a CUDA source:
``cache_sim`` (lru, lfu, plfu, plfua), ``cache_sim/wlfu``,
``cache_sim/tinylfu`` (with or without the doorkeeper),
``cache_sim/plfua_dyn``, ``cache_sim/sized`` (gdsf, and lru/lfu/plfu/plfua/
gdsf under a byte budget), ``cache_sim/plfua_dyn_bytes`` (plfua_dyn under a
byte budget, from the same source as ``cache_sim/plfua_dyn``) and
``cache_sim/arc``. Byte mode takes an ``(N,)`` int32 size row shared by the
samples (``None`` = unit sizes); as in the reference kernel, wlfu, tinylfu
and arc do not run under a byte budget, and kinds that are not size-aware
ignore ``sizes``. None of the programs records telemetry.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from repro_torch.core import sketch, torch_cache
from repro_torch.kernels import _build

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


PROGRAMS = {
    p.name: p
    for p in (
        Program("cache_sim", _CSRC / "cache_sim.cu", "cache_sim_launch",
                (_PTR,) * 4 + (_INT,) * 7 + (_PTR,)),
        Program("cache_sim/wlfu", _CSRC / "wlfu.cu", "wlfu_launch",
                (_PTR,) * 6 + (_INT,) * 6 + (_PTR,)),
        Program("cache_sim/tinylfu", _CSRC / "tinylfu.cu", "tinylfu_launch",
                (_PTR,) * 7 + (_INT,) * 8 + (_PTR,)),
        Program("cache_sim/plfua_dyn", _CSRC / "plfua_dyn.cu", "plfua_dyn_launch",
                (_PTR,) * 8 + (_INT,) * 8 + (_PTR,)),
        Program("cache_sim/plfua_dyn_bytes", _CSRC / "plfua_dyn.cu", "plfua_dyn_bytes_launch",
                (_PTR,) * 10 + (_INT,) * 10 + (_PTR,)),
        Program("cache_sim/sized", _CSRC / "sized.cu", "sized_launch",
                (_PTR,) * 8 + (_INT,) * 9 + (_PTR,)),
        Program("cache_sim/arc", _CSRC / "arc.cu", "arc_launch",
                (_PTR,) * 7 + (_INT,) * 5 + (_PTR,)),
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

#: kernel launches per program since import (or since a caller last set them to 0)
LAUNCHES = dict.fromkeys(PROGRAMS, 0)


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


def _sizes_row(spec: torch_cache.PolicySpec, sizes, device) -> torch.Tensor | None:
    """The ``(N,)`` int32 size row a size-aware spec runs with (unit sizes for
    ``None``), contiguous on ``device``; ``None`` for a spec that ignores
    sizes, as the reference kernel ignores them. Raises on a wrong shape and
    on a size below 1 (gdsf divides by it)."""
    if not spec.size_aware:
        return None
    n = spec.n_objects
    if sizes is None:
        return torch.ones(n, dtype=torch.int32, device=device)
    sizes = torch.as_tensor(sizes, dtype=torch.int32, device=device).contiguous()
    if tuple(sizes.shape) != (n,):
        raise ValueError(f"sizes must have shape ({n},), got {tuple(sizes.shape)}")
    if n and int(sizes.min()) < 1:
        raise ValueError("sizes must be >= 1")
    return sizes


def _derived_inserts(traces: torch.Tensor, hits: torch.Tensor, spec: torch_cache.PolicySpec) -> torch.Tensor:
    """The object-count kinds without a sketch: every admitted miss inserts
    (arc's too: a cold miss into T1, a ghost hit into T2), and only plfua
    refuses misses (ids at or above its hot-set size), so inserts follow
    from the hits."""
    admitted = (traces < spec.effective_hot).sum(dim=1) if spec.kind == "plfua" else traces.shape[1]
    return (admitted - hits).to(torch.int32)


def _launch_args(spec: torch_cache.PolicySpec, traces: torch.Tensor, sizes: torch.Tensor | None):
    """The kind's program, its outputs (zeroed) with the scratch it needs, and
    the C entry's arguments before the device and the stream, on the tensors'
    own device. The scratch (score row, tags, ring, sketch rows, bloom, hot
    mask, estimates) is freed on return; the caching allocator hands it out
    again only in stream order, after the launch."""
    s, t = traces.shape
    n = spec.n_objects
    dev = traces.device
    zeros = lambda *shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype, device=dev)
    program = program_of(spec.kind, spec.capacity_bytes)
    outs = dict(hits=zeros(s), freq=zeros(s, n), in_cache=zeros(s, n, dtype=torch.bool), inserts=zeros(s))
    ptr = lambda *tensors: [a.data_ptr() for a in tensors]
    hits, freq, in_cache, inserts = (outs[k] for k in OUTPUTS)
    dims = [s, t, n]
    if program == "cache_sim":
        return program, outs, ptr(traces, hits, freq, in_cache) + dims + [
            _KIND_CODE[spec.kind], spec.capacity, spec.effective_hot]
    if sizes is not None:
        outs["hit_bytes"] = zeros(s, dtype=torch.int64)
    if program == "cache_sim/sized":
        outs["_score"] = zeros(s, n) if spec.kind == "gdsf" else zeros(1)
        return program, outs, ptr(traces, sizes, hits, inserts, outs["hit_bytes"], freq, in_cache,
                                  outs["_score"]) + dims + [
            _KIND_CODE[spec.kind], spec.capacity, spec.effective_hot, spec.capacity_bytes,
            spec.effective_max_victims if spec.capacity_bytes else 0]
    if program == "cache_sim/arc":
        outs.update(dir_size=zeros(s), argmins=zeros(s), _lst=zeros(s, n, dtype=torch.uint8))
        return program, outs, ptr(traces, hits, outs["dir_size"], outs["argmins"], freq, in_cache,
                                  outs["_lst"]) + dims + [spec.capacity]
    if program == "cache_sim/wlfu":
        outs["_ring"] = torch.full((s, spec.window), -1, dtype=torch.int32, device=dev)
        return program, outs, ptr(traces, hits, inserts, freq, in_cache, outs["_ring"]) + dims + [
            spec.capacity, spec.window]
    width = spec.effective_sketch_width
    outs["_rows"] = zeros(s, sketch.DEPTH, width)
    if program == "cache_sim/tinylfu":
        outs["_bloom"] = zeros(s, spec.doorkeeper, dtype=torch.uint8)
        return program, outs, ptr(traces, hits, inserts, freq, in_cache, outs["_rows"],
                                  outs["_bloom"]) + dims + [
            spec.capacity, spec.effective_window, width, spec.doorkeeper]
    outs["_hot"] = torch.empty((s, n), dtype=torch.uint8, device=dev)
    outs["_est"] = torch.empty((s, n), dtype=torch.int32, device=dev)
    scratch = ptr(outs["_rows"], outs["_hot"], outs["_est"])
    options = [spec.capacity, spec.effective_hot, spec.effective_refresh, width]
    if program == "cache_sim/plfua_dyn":
        return program, outs, ptr(traces, hits, inserts, freq, in_cache) + scratch + dims + options
    return program, outs, ptr(traces, sizes, hits, inserts, outs["hit_bytes"], freq,
                              in_cache) + scratch + dims + options + [spec.capacity_bytes, spec.effective_max_victims]


def cache_sim_cuda(traces: torch.Tensor, *, kind: str, n_objects: int, capacity: int, hot_size: int = 0,
                   window: int = 0, refresh: int = 0, sketch_width: int = 0, doorkeeper: int = 0,
                   capacity_bytes: int = 0, max_victims: int = 0, sizes=None) -> dict:
    """Launch the kind's program on ``traces`` ((S, T) int32, contiguous, on
    a CUDA device) and return its outputs by name: ``hits``, ``freq``,
    ``in_cache``, ``inserts``, a size-aware run's ``hit_bytes``, and arc's
    ``dir_size`` and ``argmins``. Raises on anything the kernel does not take,
    and if the launch fails."""
    if not isinstance(traces, torch.Tensor) or not traces.is_cuda:
        raise ValueError("cache_sim_cuda takes a CUDA tensor; cache_sim_plain is the CPU version")
    spec = spec_of(kind, n_objects, capacity, hot_size, window, refresh, sketch_width, doorkeeper,
                   capacity_bytes, max_victims)
    _check_traces(traces, n_objects)
    dev = traces.device
    program, outs, args = _launch_args(spec, traces, _sizes_row(spec, sizes, dev))
    if traces.shape[0]:
        built = library(program)
        err = getattr(built.lib, PROGRAMS[program].entry)(
            *args,
            dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            msg = built.lib.cache_sim_error_string(err).decode()
            raise RuntimeError(f"{program} kernel launch failed: CUDA error {err} ({msg})")
        LAUNCHES[program] += 1
    if program in ("cache_sim", "cache_sim/arc"):
        outs["inserts"] = _derived_inserts(traces, outs["hits"], spec)
    return {k: v for k, v in outs.items() if not k.startswith("_")}


def cache_sim_plain(traces: torch.Tensor, *, kind: str, n_objects: int, capacity: int, hot_size: int = 0,
                    window: int = 0, refresh: int = 0, sketch_width: int = 0, doorkeeper: int = 0,
                    capacity_bytes: int = 0, max_victims: int = 0, sizes=None) -> dict:
    """The kernel's contract computed with ``torch_cache`` on the tensor's own
    device: the CPU path of ``ops.cache_sim``, and the yardstick the kernel is
    held to on the card. The same names as :func:`cache_sim_cuda`
    (arc's ``dir_size`` from the final tags; no ``argmins``: the plain
    version runs every search)."""
    spec = spec_of(kind, n_objects, capacity, hot_size, window, refresh, sketch_width, doorkeeper,
                   capacity_bytes, max_victims)
    _check_traces(traces, n_objects)
    sizes = _sizes_row(spec, sizes, traces.device)
    hit_series, state = torch_cache.simulate_batch(spec, traces, sizes=sizes, device=traces.device)
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
    return outs

