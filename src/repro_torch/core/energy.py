"""Energy models: the paper's CPU-time metric in Joules, and device energy
from a measured device interval at the card's power limit.

Paper host: Intel Xeon Gold 6130 (TDP 125 W, 32 cores) — the management loop is
single-threaded, so we charge one core's TDP share plus an uncore allowance.
The card's power is never a constant here: callers pass the limit that
``nvidia-smi`` reports for the card that ran the work
(:func:`repro_torch._device.card_info`).
"""
from __future__ import annotations

XEON_6130_TDP_W = 125.0
XEON_6130_CORES = 32
CPU_CORE_POWER_W = XEON_6130_TDP_W / XEON_6130_CORES * 1.5  # +50% uncore share


def mgmt_energy_j(cpu_seconds: float, core_power_w: float = CPU_CORE_POWER_W) -> float:
    """The paper's metric, converted: E = t_cpu * P_core."""
    return cpu_seconds * core_power_w


def device_energy_j(seconds: float, power_w: float) -> float:
    """Upper-bound device energy of a measured interval: E = t_device * P_limit
    (the card draws at most its power limit)."""
    if power_w <= 0:
        raise ValueError(f"power_w must be > 0, got {power_w}")
    return seconds * power_w
