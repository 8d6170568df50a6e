"""Public entry point of the cache_sim kernel."""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.core import registry
from repro_torch.kernels.cache_sim.cache_sim import cache_sim_cuda, cache_sim_plain

_ALL_KINDS = registry.names(pallas=True)


def cache_sim(
    traces,
    *,
    kind: str,
    n_objects: int,
    capacity: int,
    hot_size: int = 0,
    window: int = 0,
    refresh: int = 0,
    sketch_width: int = 0,
    doorkeeper: int = 0,
    telemetry_window: int = 0,
    capacity_bytes: int = 0,
    max_victims: int = 0,
    sizes=None,
    n_groups: int = 0,
    groups=None,
    device=None,
):
    """Batched cache-policy simulation of ``(S, T)`` traces; returns
    ``(hits (S,) int32, freq (S, N) int32, in_cache (S, N) bool)``, and with
    ``telemetry_window = W > 0`` a fourth output, the windowed series
    ``(S, n_windows, N_METRICS)`` int32 (``(S, n_windows, n_groups,
    N_METRICS)`` with ``n_groups``); see
    :mod:`repro_torch.kernels.cache_sim.cache_sim` for the contract.

    Runs the CUDA kernel on the card (``device=None`` means ``cuda``) and the
    plain PyTorch version only when ``device="cpu"``. The signature is the
    reference's, and so are the option rules: ``window`` is wlfu's (required)
    and tinylfu's aging window, ``refresh`` and ``hot_size`` plfua_dyn's,
    ``sketch_width`` the sketch kinds', ``doorkeeper`` tinylfu's; 0 takes the
    reference's default, and a kind ignores the options that are not its own.
    ``capacity_bytes`` > 0 sets a byte budget over ``sizes`` (an ``(N,)``
    int32 row shared by the samples; ``None`` = unit sizes), with at most
    ``max_victims`` evictions an insertion; as in the reference kernel, wlfu,
    tinylfu and arc under a byte budget raise ``ValueError``, and kinds that
    are not size-aware ignore ``sizes``. ``telemetry_window`` must be >= 0;
    ``n_groups`` needs ``telemetry_window`` and a ``groups`` catalogue (an
    ``(N,)`` int32 row shared by the samples, values in ``[0, n_groups)``).
    A telemetry call on a CUDA tensor runs the kernel's telemetry instance.
    """
    outs = cache_sim_outputs(
        traces, kind=kind, n_objects=n_objects, capacity=capacity, hot_size=hot_size, window=window,
        refresh=refresh, sketch_width=sketch_width, doorkeeper=doorkeeper,
        telemetry_window=telemetry_window, capacity_bytes=capacity_bytes, max_victims=max_victims,
        sizes=sizes, n_groups=n_groups, groups=groups, device=device,
    )
    if telemetry_window:
        return outs["hits"], outs["freq"], outs["in_cache"], outs["series"]
    return outs["hits"], outs["freq"], outs["in_cache"]


def cache_sim_outputs(
    traces,
    *,
    kind: str,
    n_objects: int,
    capacity: int,
    hot_size: int = 0,
    window: int = 0,
    refresh: int = 0,
    sketch_width: int = 0,
    doorkeeper: int = 0,
    telemetry_window: int = 0,
    capacity_bytes: int = 0,
    max_victims: int = 0,
    sizes=None,
    n_groups: int = 0,
    groups=None,
    device=None,
) -> dict:
    """:func:`cache_sim`'s outputs by name: ``hits``, ``freq``, ``in_cache``,
    ``inserts``, a size-aware run's ``hit_bytes``, arc's ``dir_size`` and a
    telemetry run's ``series`` (see
    :mod:`repro_torch.kernels.cache_sim.cache_sim`), the same keys on the
    card and on the CPU. The grid harness reads evictions, byte hits and
    arc's directory from them."""
    if kind not in _ALL_KINDS:
        raise ValueError(f"kind={kind!r} not in {_ALL_KINDS}")
    if doorkeeper < 0:
        raise ValueError(f"doorkeeper must be >= 0, got {doorkeeper}")
    if doorkeeper and kind != "tinylfu":
        raise ValueError("doorkeeper is a tinylfu-only option")
    dev = resolve_device(device)
    traces = torch.as_tensor(traces, dtype=torch.int32, device=dev).contiguous()
    # the plain version runs only on a CPU tensor; a CUDA tensor always launches the kernel
    run = cache_sim_cuda if traces.is_cuda else cache_sim_plain
    outs = run(
        traces, kind=kind, n_objects=n_objects, capacity=capacity, hot_size=hot_size, window=window,
        refresh=refresh, sketch_width=sketch_width, doorkeeper=doorkeeper, capacity_bytes=capacity_bytes,
        max_victims=max_victims, sizes=sizes, telemetry_window=telemetry_window, n_groups=n_groups,
        groups=groups,
    )
    outs.pop("argmins", None)  # arc's search count: the kernel's own diagnostic, not part of the contract
    return outs
