"""Device timing on the card with the first-call/execute split.

* **first call** — the first call of a kernel wrapper builds and loads its
  library; ``compile_s`` is that call's wall time, ended by a synchronise, and
  is never folded into the execute time.
* **warmup** — at least one more untimed call precedes the clock.
* **CUDA events** — PyTorch returns before the card finishes, so every timed
  call is bracketed by CUDA events on the current stream and followed by a
  synchronise; ``execute_s`` is device time.

* **profile** — with ``profile_dir``, one more untimed call runs under
  ``torch.profiler`` after the timed ones (the counterpart of the
  reference's ``jax.profiler.trace``), writing a Chrome trace into the
  directory (on the card its CUDA activity only); :class:`DeviceTrace`
  summarises the device's kernels in it and the share of their span in
  which no kernel ran.

``Timing.j_per_step`` prices the measured device time at the card's power
limit (:func:`repro_torch.core.energy.device_energy_j`), an upper bound on the
energy the card drew; the module's :func:`j_per_step` prices a measured CPU
interval as management energy (the reference's function of that name). Measuring needs a card: there is no CPU fallback
(:func:`profile` alone also runs on the CPU, where it sees no device time).
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from repro_torch._device import card_info, resolve_device
from repro_torch.core import energy


@dataclasses.dataclass(frozen=True)
class DeviceTrace:
    """One profiled call: the Chrome trace written, the device kernels seen
    in it, the time some kernel ran (the union of their intervals) and the
    span from the first kernel's start to the last one's end."""

    path: Path | None
    kernels: int
    busy_s: float
    span_s: float

    @property
    def idle_share(self) -> float | None:
        """The share of the kernels' span with no kernel running (``None``
        when the trace holds no device time)."""
        return 1.0 - self.busy_s / self.span_s if self.span_s > 0 else None


def _busy_and_span(intervals: list[tuple[float, float]]) -> tuple[float, float]:
    """(union length, first start to last end) of ``(start, end)`` intervals."""
    if not intervals:
        return 0.0, 0.0
    intervals.sort()
    busy, (cur_lo, cur_hi) = 0.0, intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return busy, max(hi for _, hi in intervals) - intervals[0][0]


def profile(fn, *args, profile_dir, **kwargs) -> DeviceTrace:
    """Run ``fn(*args, **kwargs)`` once under ``torch.profiler`` and write its
    Chrome trace to ``profile_dir/trace.json`` (``profile_dir=None`` writes
    none: the JSON of a call of a hundred thousand launches takes seconds to
    write, and the summary does not read it). Where there is a card it
    records CUDA activity only (the kernels and the runtime calls that launch
    them): recording every host op too slows the host several times over, which
    inflates the idle share it measures and costs seconds a call. Elsewhere it
    records the host's ops. Kernels launched by the port's own libraries are
    traced too: CUPTI records every kernel on the device."""
    activity = torch.profiler.ProfilerActivity
    activities = [activity.CUDA if torch.cuda.is_available() else activity.CPU]
    with torch.profiler.profile(activities=activities) as prof:
        fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = None
    if profile_dir is not None:
        out = Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / "trace.json"
        prof.export_chrome_trace(str(path))
    # the raw kineto events: ``prof.events()`` builds a Python event tree first, which costs about a
    # millisecond a kernel (minutes for a call of a few hundred thousand launches)
    kernels = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and e.end_ns() > e.start_ns()]
    busy_ns, span_ns = _busy_and_span(kernels)
    return DeviceTrace(path=path, kernels=len(kernels), busy_s=busy_ns / 1e9, span_s=span_ns / 1e9)


@dataclasses.dataclass(frozen=True)
class Timing:
    """One measured run: ``execute_s`` is best-of-``repeats`` device seconds
    per call; ``steps`` is the simulated-request count the caller attributes
    to one call; ``power_w`` the card's power limit; ``card`` its
    ``name, limit`` label."""

    steps: int
    repeats: int
    compile_s: float
    execute_s: float
    mean_execute_s: float
    power_w: float
    card: str
    trace: DeviceTrace | None = None

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.execute_s if self.execute_s > 0 else float("inf")

    @property
    def us_per_step(self) -> float:
        return self.execute_s / self.steps * 1e6

    @property
    def j_per_step(self) -> float:
        """Device energy per simulated request at the card's power limit."""
        return energy.device_energy_j(self.execute_s, self.power_w) / self.steps


def j_per_step(cpu_seconds: float, steps: int) -> float:
    """Management J per request from a measured CPU interval — the measured
    counterpart of the analytic per-op energy tables."""
    return energy.mgmt_energy_j(cpu_seconds) / steps


def measure(fn, *args, steps: int, repeats: int = 3, warmup: int = 1, make_args=None, profile_dir=None,
            **kwargs) -> Timing:
    """Time ``fn(*args, **kwargs)`` on the card.

    ``make_args``: a thunk returning a fresh ``args`` tuple, called before the
    clock each time, for a ``fn`` that consumes or updates its inputs in
    place. ``args`` are then used only by the first call.

    ``profile_dir``: when set, one more call runs under :func:`profile` after
    the timed ones, outside the clock, and ``Timing.trace`` summarises it.
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    resolve_device("cuda")
    card = card_info()
    prep = (lambda: args) if make_args is None else make_args

    t0 = time.perf_counter()
    fn(*args, **kwargs)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup, 1)):
        fn(*prep(), **kwargs)
    torch.cuda.synchronize()

    times = []
    for _ in range(max(repeats, 1)):
        a = prep()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*a, **kwargs)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    trace = None if profile_dir is None else profile(fn, *prep(), profile_dir=profile_dir, **kwargs)
    return Timing(
        steps=int(steps),
        repeats=len(times),
        compile_s=compile_s,
        execute_s=min(times),
        mean_execute_s=sum(times) / len(times),
        power_w=card.power_limit_w,
        card=card.label,
        trace=trace,
    )
