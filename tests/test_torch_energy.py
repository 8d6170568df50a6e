"""The paper's CPU-time measurement and the serving-energy model, against the reference.

``run_trace`` and ``hit_miss_scatter`` time the port's copy of the pure-Python
policies; every field of their results but the measured times must equal the
reference's on the same trace. ``serving_energy`` prices FLOPs on a device
whose peak rate and power are parameters: given the reference's peak and
power it must give the reference's report, to the last bit.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import energy as ref_energy
from repro.core import policies as ref_policies
from repro.core import simulate as ref_simulate
from repro_torch import _device
from repro_torch.core import energy, policies, simulate, zipf

TIMES = ("cpu_time_s", "wall_time_s")


@pytest.mark.parametrize("kind", policies.POLICY_NAMES)
def test_run_trace_matches_reference(kind):
    trace = zipf.sample_trace(500, 4_000, seed=3)
    kw = dict(n_objects=500, **({"window": 300} if kind == "wlfu" else {}))
    got = simulate.run_trace(policies.make_policy(kind, 25, **kw), trace)
    want = ref_simulate.run_trace(ref_policies.make_policy(kind, 25, **kw), trace)
    strip = lambda r: {k: v for k, v in dataclasses.asdict(r).items() if k not in TIMES}
    assert strip(got) == strip(want)
    assert [f.name for f in dataclasses.fields(simulate.SimResult)] == [
        f.name for f in dataclasses.fields(ref_simulate.SimResult)]
    assert got.cpu_time_s >= 0 and got.wall_time_s > 0
    assert got.hits + got.misses == 4_000


@pytest.mark.parametrize("kind", ("lru", "plfua", "arc"))
def test_hit_miss_scatter_matches_reference(kind):
    trace = zipf.sample_trace(300, 3_000, seed=5)
    got = simulate.hit_miss_scatter(policies.make_policy(kind, 20, n_objects=300), trace, 300)
    want = ref_simulate.hit_miss_scatter(ref_policies.make_policy(kind, 20, n_objects=300), trace, 300)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert int(got[0].sum() + got[1].sum()) == 3_000


@pytest.mark.parametrize("chr_value,n_params,prompt,new,mgmt", [
    (0.6, 409e6, 2_048, 8, 0.013), (0.0, 7e9, 512, 128, 0.0), (1.0, 1.5e9, 64, 1, 2.5)])
@pytest.mark.parametrize("efficiency,power", [(0.4, 200.0), (0.25, 700.0)])
def test_serving_energy_is_the_reference_formula(chr_value, n_params, prompt, new, mgmt, efficiency, power):
    want = ref_energy.serving_energy(chr_value, 40, n_params, prompt, new, mgmt, efficiency, chip_power_w=power)
    got = energy.serving_energy(chr_value, 40, n_params, prompt, new, mgmt, efficiency, power_w=power,
                                peak_flops=ref_energy.TPU_V5E_PEAK_BF16_FLOPS)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()
    assert (got.e_recompute_j, got.e_decode_total_j, got.e_total_j) == (
        want.e_recompute_j, want.e_decode_total_j, want.e_total_j)
    flops = energy.prefill_flops(n_params, prompt)
    assert flops == ref_energy.prefill_flops(n_params, prompt)
    assert energy.decode_flops(n_params, new) == ref_energy.decode_flops(n_params, new)
    assert energy.compute_energy_j(flops, ref_energy.TPU_V5E_PEAK_BF16_FLOPS, power, efficiency) == (
        ref_energy.tpu_energy_j(flops, efficiency, power_w=power))


def test_serving_energy_reads_the_card_power_limit(monkeypatch):
    """With no power given the model prices at the card's limit from
    nvidia-smi, at the H100 SXM's data-sheet peak."""
    card = _device.CardInfo(name="NVIDIA H100 80GB HBM3", power_limit_w=650.0, max_sm_clock_mhz=1980.0)
    monkeypatch.setattr(_device, "card_info", lambda index=None: card)
    got = energy.serving_energy(0.5, 10, 1e9, 1_000, 10, 0.0)
    assert got == energy.serving_energy(0.5, 10, 1e9, 1_000, 10, 0.0, power_w=650.0)
    assert got.e_prefill_j == pytest.approx(2e12 / (989e12 * 0.4) * 650.0, rel=1e-15)
    assert energy.H100_SXM_PEAK_BF16_FLOPS == 989e12
    with pytest.raises(ValueError):
        energy.compute_energy_j(1.0, 0.0, 700.0)
    with pytest.raises(ValueError):
        energy.compute_energy_j(1.0, 989e12, 0.0)


def test_cpu_half_is_the_reference_s():
    assert energy.CPU_CORE_POWER_W == ref_energy.CPU_CORE_POWER_W
    assert energy.mgmt_energy_j(3.5) == ref_energy.mgmt_energy_j(3.5)
