"""Energy models: the paper's CPU-time metric in Joules, device energy from a
measured device interval at the card's power limit, and the serving energy
that prices cache hits in saved prefill FLOPs.

Paper host: Intel Xeon Gold 6130 (TDP 125 W, 32 cores) — the management loop is
single-threaded, so we charge one core's TDP share plus an uncore allowance.
The card's power is never a constant here: callers pass the limit that
``nvidia-smi`` reports for the card that ran the work
(:func:`repro_torch._device.card_info`), which :func:`serving_energy` reads
itself when it is not given.
"""
from __future__ import annotations

import dataclasses

XEON_6130_TDP_W = 125.0
XEON_6130_CORES = 32
CPU_CORE_POWER_W = XEON_6130_TDP_W / XEON_6130_CORES * 1.5  # +50% uncore share

#: NVIDIA H100 SXM dense bf16 tensor-core rate (NVIDIA's data sheet)
H100_SXM_PEAK_BF16_FLOPS = 989e12


def mgmt_energy_j(cpu_seconds: float, core_power_w: float = CPU_CORE_POWER_W) -> float:
    """The paper's metric, converted: E = t_cpu * P_core."""
    return cpu_seconds * core_power_w


def device_energy_j(seconds: float, power_w: float) -> float:
    """Upper-bound device energy of a measured interval: E = t_device * P_limit
    (the card draws at most its power limit)."""
    if power_w <= 0:
        raise ValueError(f"power_w must be > 0, got {power_w}")
    return seconds * power_w


def prefill_flops(n_params: float, prompt_len: int) -> float:
    """~2*N*L FLOPs for a dense forward pass over the prompt."""
    return 2.0 * n_params * prompt_len


def decode_flops(n_params: float, new_tokens: int) -> float:
    return 2.0 * n_params * new_tokens


def compute_energy_j(flops: float, peak_flops: float, power_w: float, efficiency: float = 0.4) -> float:
    """Energy to execute ``flops`` on one card at ``efficiency`` of its peak
    rate ``peak_flops``, drawing ``power_w``: the time the work takes at that
    rate, priced at that power."""
    if peak_flops <= 0 or efficiency <= 0:
        raise ValueError(f"peak_flops and efficiency must be > 0, got {peak_flops}, {efficiency}")
    return device_energy_j(flops / (peak_flops * efficiency), power_w)


@dataclasses.dataclass
class ServingEnergyReport:
    """E_total = n_req * [(1-CHR)*E_prefill + E_decode] + E_mgmt."""

    chr: float
    n_requests: int
    e_prefill_j: float  # per miss
    e_decode_j: float  # per request
    e_mgmt_j: float  # whole trace

    @property
    def e_recompute_j(self) -> float:
        return self.n_requests * (1.0 - self.chr) * self.e_prefill_j

    @property
    def e_decode_total_j(self) -> float:
        return self.n_requests * self.e_decode_j

    @property
    def e_total_j(self) -> float:
        return self.e_recompute_j + self.e_decode_total_j + self.e_mgmt_j

    def row(self) -> dict:
        return {
            "chr": self.chr,
            "E_recompute_J": self.e_recompute_j,
            "E_decode_J": self.e_decode_total_j,
            "E_mgmt_J": self.e_mgmt_j,
            "E_total_J": self.e_total_j,
        }


def serving_energy(
    chr_value: float,
    n_requests: int,
    n_params: float,
    prompt_len: int,
    new_tokens: int,
    mgmt_cpu_s: float,
    efficiency: float = 0.4,
    power_w: float | None = None,
    peak_flops: float = H100_SXM_PEAK_BF16_FLOPS,
) -> ServingEnergyReport:
    """A served trace's energy: every miss pays a prefill, every request its
    decode, both at ``efficiency`` of ``peak_flops`` and ``power_w`` (the
    current card's power limit from ``nvidia-smi`` when ``None``), plus the
    cache's management loop at the paper's CPU-core power."""
    if power_w is None:
        from repro_torch._device import card_info

        power_w = card_info().power_limit_w
    return ServingEnergyReport(
        chr=chr_value,
        n_requests=n_requests,
        e_prefill_j=compute_energy_j(prefill_flops(n_params, prompt_len), peak_flops, power_w, efficiency),
        e_decode_j=compute_energy_j(decode_flops(n_params, new_tokens), peak_flops, power_w, efficiency),
        e_mgmt_j=mgmt_energy_j(mgmt_cpu_s),
    )
