"""The cache_sim kernel's wrapper and its plain PyTorch version.

``cache_sim_cuda`` launches the hand-written CUDA kernel in
``csrc/cache_sim.cu`` (the counterpart of the reference's ``cache_sim_pallas``)
on a CUDA tensor; ``cache_sim_plain`` computes the same contract with
:mod:`repro_torch.core.torch_cache`. Both return

* hits:     ``(S,)``   int32 — total hits per sample (CHR = hits / T);
* freq:     ``(S, N)`` int32 — final frequency table (lru: last-access stamps
  ``t + 1``, 0 for never requested);
* in_cache: ``(S, N)`` bool  — final cache contents.

This slice covers lru, lfu, plfu and plfua in object-count mode.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import torch_cache
from repro_torch.kernels import _build

#: kinds this kernel runs (the reference's kernel runs every registry kind)
KERNEL_KINDS = torch_cache.PORTED_KINDS
_KIND_CODE = {"lru": 0, "lfu": 1, "plfu": 2, "plfua": 3}
_SOURCES = (Path(__file__).parent / "csrc" / "cache_sim.cu",)
_I32_MAX = torch.iinfo(torch.int32).max

#: kernel launches since import (or since a caller last reset it to 0)
LAUNCHES = 0


def library() -> _build.Library:
    """Build (at first use) and load the kernel library, with its C signatures."""
    built = _build.build("cache_sim", _SOURCES)
    launch = built.lib.cache_sim_launch
    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    built.lib.cache_sim_error_string.argtypes = [ctypes.c_int]
    built.lib.cache_sim_error_string.restype = ctypes.c_char_p
    return built


def _check(traces: torch.Tensor, kind: str, n_objects: int, capacity: int, hot_size: int) -> int:
    """Validate the covered options like the reference kernel's wrapper, and
    the trace; returns the normalised ``hot_size``."""
    if kind not in KERNEL_KINDS:
        raise ValueError(f"kind={kind!r} not in {KERNEL_KINDS}")
    if not isinstance(traces, torch.Tensor) or traces.ndim != 2:
        raise ValueError("traces must be an (S, T) tensor")
    if traces.dtype != torch.int32:
        raise ValueError(f"traces must be int32, got {traces.dtype}")
    if not traces.is_contiguous():
        raise ValueError("traces must be contiguous")
    if not 1 <= n_objects <= _I32_MAX:
        raise ValueError(f"n_objects must be in [1, {_I32_MAX}], got {n_objects}")
    if not -_I32_MAX <= capacity <= _I32_MAX:
        raise ValueError(f"capacity must fit int32, got {capacity}")
    if not 0 <= hot_size <= _I32_MAX:
        raise ValueError(f"hot_size must be in [0, {_I32_MAX}], got {hot_size}")
    if traces.shape[1] >= _I32_MAX:
        raise ValueError("trace length must stay below 2**31 - 1 (lru stamps are t + 1)")
    if traces.numel():
        # the kernel indexes state by id; an id outside [0, n) would write out of bounds
        lo, hi = torch.aminmax(traces)
        if int(lo) < 0 or int(hi) >= n_objects:
            raise ValueError(f"trace ids must lie in [0, {n_objects}), got [{int(lo)}, {int(hi)}]")
    if kind == "plfua":
        hot_size = min(n_objects, hot_size or 2 * capacity)
    return hot_size


def cache_sim_cuda(traces: torch.Tensor, *, kind: str, n_objects: int, capacity: int, hot_size: int = 0):
    """Launch the kernel on ``traces`` ((S, T) int32, contiguous, on a CUDA
    device) and return ``(hits, freq, in_cache)``. Raises on anything the
    kernel does not take, and if the launch fails."""
    global LAUNCHES
    if not isinstance(traces, torch.Tensor) or not traces.is_cuda:
        raise ValueError("cache_sim_cuda takes a CUDA tensor; cache_sim_plain is the CPU version")
    hot_size = _check(traces, kind, n_objects, capacity, hot_size)
    s, t = traces.shape
    dev = traces.device
    hits = torch.zeros((s,), dtype=torch.int32, device=dev)
    freq = torch.zeros((s, n_objects), dtype=torch.int32, device=dev)
    in_cache = torch.zeros((s, n_objects), dtype=torch.bool, device=dev)
    if s == 0:
        return hits, freq, in_cache
    built = library()
    err = built.lib.cache_sim_launch(
        traces.data_ptr(), hits.data_ptr(), freq.data_ptr(), in_cache.data_ptr(),
        s, t, n_objects, _KIND_CODE[kind], capacity, hot_size,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        msg = built.lib.cache_sim_error_string(err).decode()
        raise RuntimeError(f"cache_sim kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return hits, freq, in_cache


def cache_sim_plain(traces: torch.Tensor, *, kind: str, n_objects: int, capacity: int, hot_size: int = 0):
    """The kernel's contract computed with ``torch_cache`` on the tensor's own
    device: the CPU path of ``ops.cache_sim``, and the yardstick the kernel is
    held to on the card."""
    hot_size = _check(traces, kind, n_objects, capacity, hot_size)
    spec = torch_cache.PolicySpec(kind=kind, n_objects=n_objects, capacity=capacity, hot_size=hot_size)
    hit_series, state = torch_cache.simulate_batch(spec, traces, device=traces.device)
    hits = hit_series.sum(dim=1, dtype=torch.int32)
    if kind == "lru":
        # the scan keeps last-access t (0 is ambiguous); the kernel keeps t + 1, 0 = never
        seen = torch.zeros_like(state["in_cache"]).scatter_(1, traces.long(), True)
        freq = torch.where(seen, state["last"] + 1, 0)
    else:
        freq = state["freq"]
    return hits, freq.to(torch.int32), state["in_cache"]
