"""Device selection for the port's entry points.

Every public entry point runs on the card unless the caller asks for the CPU
with ``device="cpu"``; nothing falls back to the CPU quietly.
"""
from __future__ import annotations

import dataclasses
import functools
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises ``RuntimeError`` when a CUDA device is
    asked for (explicitly or by default) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch version on the CPU"
        )
    return dev


@functools.lru_cache(maxsize=32)
def arange(n: int, device: torch.device) -> torch.Tensor:
    """``torch.arange(n)`` on ``device``, made once and shared: the plain
    simulator indexes its samples with it at every request, where a new one
    would cost a kernel launch on the card. Callers must not modify it."""
    return torch.arange(n, device=device)


@dataclasses.dataclass(frozen=True)
class CardInfo:
    """What ``nvidia-smi`` reports for one card."""

    name: str
    power_limit_w: float
    max_sm_clock_mhz: float

    @property
    def label(self) -> str:
        """``name, limit W``, the form every recorded number carries."""
        return f"{self.name}, {self.power_limit_w:.2f} W"


def card_info(index: int | None = None) -> CardInfo:
    """Name, power limit and maximum SM clock of card ``index`` (the current
    device when ``None``), as ``nvidia-smi`` reports them."""
    if index is None:
        index = torch.cuda.current_device()
    out = subprocess.run(
        [
            "nvidia-smi",
            f"--id={index}",
            "--query-gpu=name,power.limit,clocks.max.sm",
            "--format=csv,noheader,nounits",
        ],
        check=True,
        capture_output=True,
        text=True,
    ).stdout.strip()
    name, power, clock = (f.strip() for f in out.rsplit(",", 2))
    return CardInfo(name=name, power_limit_w=float(power), max_sm_clock_mhz=float(clock))
