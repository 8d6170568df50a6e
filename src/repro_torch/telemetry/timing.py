"""Device timing on the card with the first-call/execute split.

* **first call** — the first call of a kernel wrapper builds and loads its
  library; ``compile_s`` is that call's wall time, ended by a synchronise, and
  is never folded into the execute time.
* **warmup** — at least one more untimed call precedes the clock.
* **CUDA events** — PyTorch returns before the card finishes, so every timed
  call is bracketed by CUDA events on the current stream and followed by a
  synchronise; ``execute_s`` is device time.

``Timing.j_per_step`` prices the measured device time at the card's power
limit (:func:`repro_torch.core.energy.device_energy_j`), an upper bound on the
energy the card drew. Measuring needs a card: there is no CPU fallback.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch._device import card_info, resolve_device
from repro_torch.core import energy


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


def measure(fn, *args, steps: int, repeats: int = 3, warmup: int = 1, make_args=None, **kwargs) -> Timing:
    """Time ``fn(*args, **kwargs)`` on the card.

    ``make_args``: a thunk returning a fresh ``args`` tuple, called before the
    clock each time, for a ``fn`` that consumes or updates its inputs in
    place. ``args`` are then used only by the first call.
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
    return Timing(
        steps=int(steps),
        repeats=len(times),
        compile_s=compile_s,
        execute_s=min(times),
        mean_execute_s=sum(times) / len(times),
        power_w=card.power_limit_w,
        card=card.label,
    )
