"""The cache_sim kernel's wrapper and its plain PyTorch version.

``cache_sim_cuda`` launches the hand-written CUDA programs in ``csrc/`` (the
counterparts of the programs of the reference's ``cache_sim_pallas``) on a
CUDA tensor; ``cache_sim_plain`` computes the same contract with
:mod:`repro_torch.core.torch_cache`. Both return

* hits:     ``(S,)``   int32 — total hits per sample (CHR = hits / T);
* freq:     ``(S, N)`` int32 — final frequency table (lru: last-access stamps
  ``t + 1``, 0 for never requested; wlfu: counts in the last ``window``);
* in_cache: ``(S, N)`` bool  — final cache contents;
* inserts:  ``(S,)``   int32 — insertions per sample (evictions = inserts -
  final occupancy), the counterpart of the reference simulator's
  ``state["inserts"]``; ``ops.cache_sim`` drops it, as the reference kernel
  has no such output.

Each kind runs one of four programs, each its own CUDA source and library:
``cache_sim`` (lru, lfu, plfu, plfua), ``cache_sim/wlfu``,
``cache_sim/tinylfu`` (with or without the doorkeeper) and
``cache_sim/plfua_dyn``. All run in object-count mode without telemetry.
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
_KIND_CODE = {"lru": 0, "lfu": 1, "plfu": 2, "plfua": 3}
_CSRC = Path(__file__).parent / "csrc"
_I32_MAX = torch.iinfo(torch.int32).max
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


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
        return self.name.replace("/", "_")


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
    )
}
#: the program that runs each kind
PROGRAM_OF = {
    **{kind: "cache_sim" for kind in _KIND_CODE},
    "wlfu": "cache_sim/wlfu",
    "tinylfu": "cache_sim/tinylfu",
    "plfua_dyn": "cache_sim/plfua_dyn",
}

#: kernel launches per program since import (or since a caller last set them to 0)
LAUNCHES = dict.fromkeys(PROGRAMS, 0)


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
            refresh: int = 0, sketch_width: int = 0, doorkeeper: int = 0) -> torch_cache.PolicySpec:
    """Validate a call's options like the reference kernel's wrapper
    (``cache_sim_pallas``) and return them as a spec: its ``effective_*``
    values are the options the kernel runs with (each 0 takes the
    reference's default; a kind ignores the options not its own)."""
    if kind not in KERNEL_KINDS:
        raise ValueError(f"kind={kind!r} not in {KERNEL_KINDS}")
    _in_range("n_objects", n_objects, 1)
    _in_range("capacity", capacity, -_I32_MAX)
    for name, value in (("hot_size", hot_size), ("window", window), ("refresh", refresh),
                        ("sketch_width", sketch_width), ("doorkeeper", doorkeeper)):
        _in_range(name, value, 0)
    # PolicySpec raises the reference's errors for wlfu's window and the doorkeeper
    return torch_cache.PolicySpec(kind, n_objects, capacity, hot_size=hot_size, window=window,
                                  refresh=refresh, sketch_width=sketch_width, doorkeeper=doorkeeper)


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


def _derived_inserts(traces: torch.Tensor, hits: torch.Tensor, spec: torch_cache.PolicySpec) -> torch.Tensor:
    """The kinds without a sketch: every admitted miss inserts, and only
    plfua refuses misses (ids at or above its hot-set size), so inserts
    follow from the hits."""
    admitted = (traces < spec.effective_hot).sum(dim=1) if spec.kind == "plfua" else traces.shape[1]
    return (admitted - hits).to(torch.int32)


def cache_sim_cuda(traces: torch.Tensor, *, kind: str, n_objects: int, capacity: int, hot_size: int = 0,
                   window: int = 0, refresh: int = 0, sketch_width: int = 0, doorkeeper: int = 0):
    """Launch the kind's program on ``traces`` ((S, T) int32, contiguous, on
    a CUDA device) and return ``(hits, freq, in_cache, inserts)``. Raises on
    anything the kernel does not take, and if the launch fails."""
    if not isinstance(traces, torch.Tensor) or not traces.is_cuda:
        raise ValueError("cache_sim_cuda takes a CUDA tensor; cache_sim_plain is the CPU version")
    spec = spec_of(kind, n_objects, capacity, hot_size, window, refresh, sketch_width, doorkeeper)
    _check_traces(traces, n_objects)
    s, t = traces.shape
    dev = traces.device
    zeros = lambda *shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype, device=dev)
    hits, inserts = zeros(s), zeros(s)
    freq, in_cache = zeros(s, n_objects), zeros(s, n_objects, dtype=torch.bool)
    if s == 0:
        return hits, freq, in_cache, inserts
    program = PROGRAM_OF[kind]
    built = library(program)
    # the programs' scratch (ring, sketch rows, bloom, hot mask, estimates) is
    # freed on return; the caching allocator hands it out again only in stream
    # order, after this launch
    outs = (traces, hits) if program == "cache_sim" else (traces, hits, inserts)
    ptrs = [a.data_ptr() for a in outs + (freq, in_cache)]
    sizes = [s, t, n_objects]
    if program == "cache_sim":
        ints = sizes + [_KIND_CODE[kind], capacity, spec.effective_hot]
    elif program == "cache_sim/wlfu":
        ring = torch.full((s, spec.window), -1, dtype=torch.int32, device=dev)
        ptrs.append(ring.data_ptr())
        ints = sizes + [capacity, spec.window]
    elif program == "cache_sim/tinylfu":
        rows = zeros(s, sketch.DEPTH, spec.effective_sketch_width)
        bloom = zeros(s, spec.doorkeeper, dtype=torch.uint8)
        ptrs += [rows.data_ptr(), bloom.data_ptr()]
        ints = sizes + [capacity, spec.effective_window, spec.effective_sketch_width, spec.doorkeeper]
    else:
        rows = zeros(s, sketch.DEPTH, spec.effective_sketch_width)
        hot = torch.empty((s, n_objects), dtype=torch.uint8, device=dev)
        est = torch.empty((s, n_objects), dtype=torch.int32, device=dev)
        ptrs += [rows.data_ptr(), hot.data_ptr(), est.data_ptr()]
        ints = sizes + [capacity, spec.effective_hot, spec.effective_refresh, spec.effective_sketch_width]
    err = getattr(built.lib, PROGRAMS[program].entry)(
        *ptrs, *ints,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        msg = built.lib.cache_sim_error_string(err).decode()
        raise RuntimeError(f"{program} kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[program] += 1
    if program == "cache_sim":
        inserts = _derived_inserts(traces, hits, spec)
    return hits, freq, in_cache, inserts


def cache_sim_plain(traces: torch.Tensor, *, kind: str, n_objects: int, capacity: int, hot_size: int = 0,
                    window: int = 0, refresh: int = 0, sketch_width: int = 0, doorkeeper: int = 0):
    """The kernel's contract computed with ``torch_cache`` on the tensor's own
    device: the CPU path of ``ops.cache_sim``, and the yardstick the kernel is
    held to on the card."""
    spec = spec_of(kind, n_objects, capacity, hot_size, window, refresh, sketch_width, doorkeeper)
    _check_traces(traces, n_objects)
    hit_series, state = torch_cache.simulate_batch(spec, traces, device=traces.device)
    hits = hit_series.sum(dim=1, dtype=torch.int32)
    if kind == "lru":
        # the scan keeps last-access t (0 is ambiguous); the kernel keeps t + 1, 0 = never
        seen = torch.zeros_like(state["in_cache"]).scatter_(1, traces.long(), True)
        freq = torch.where(seen, state["last"] + 1, 0)
    else:
        freq = state["freq"]
    if kind in torch_cache.SKETCH_KINDS:
        inserts = state["inserts"]
    else:
        inserts = _derived_inserts(traces, hits, spec)
    return hits, freq.to(torch.int32), state["in_cache"], inserts
