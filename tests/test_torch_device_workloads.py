"""The port's device trace generators against the reference's device contracts, on the CPU.

``repro_torch.workloads.device`` draws its traces from ``torch.Generator``
streams, which cannot reproduce ``jax.random``'s bits, so the generators are
held to the contracts that ``tests/test_workloads.py`` sets the reference's
device generators: shape, dtype and range; deterministic per seed and
sensitive to it; independent samples; the Zipf head dominates; each
scenario's semantics; unknown overrides rejected. Sample ``i`` is a pure
function of ``(seed, i)``, whatever the batch. ``tests/test_torch_cuda.py``
runs the same contracts on the card.
"""
import numpy as np
import pytest
import torch

from repro.workloads import device as ref_device
from repro_torch import workloads
from repro_torch.workloads.device import (
    DEVICE_SCENARIO_NAMES,
    DeviceTraceSpec,
    gen_sample,
    gen_stream_chunk,
    make_traces_device,
    object_sizes_device,
    sample_key,
    stream_chunk_key,
)

N = 400


def _make(scenario, seed=11, n=N, s=2, t=3_000, device="cpu", **overrides):
    dspec = DeviceTraceSpec(scenario, n, n_samples=s, trace_len=t, seed=seed, overrides=tuple(overrides.items()))
    return make_traces_device(dspec, device=device).cpu().numpy()


def test_scenarios_and_options_are_the_reference_s():
    assert DEVICE_SCENARIO_NAMES == ref_device.DEVICE_SCENARIO_NAMES == workloads.SCENARIO_NAMES
    from repro_torch.workloads import device

    assert device._SCENARIO_OPTS == ref_device._SCENARIO_OPTS


@pytest.mark.parametrize("scenario", DEVICE_SCENARIO_NAMES)
def test_contract(scenario):
    tr = _make(scenario)
    assert tr.shape == (2, 3_000)
    assert tr.dtype == np.int32
    assert tr.min() >= 0 and tr.max() < N


@pytest.mark.parametrize("scenario", DEVICE_SCENARIO_NAMES)
def test_deterministic_and_seed_sensitive(scenario):
    a = _make(scenario, seed=5)
    np.testing.assert_array_equal(a, _make(scenario, seed=5))
    assert (a != _make(scenario, seed=6)).any()
    assert (a[0] != a[1]).any()  # samples independent


def test_zipf_head_dominates():
    for scenario in DEVICE_SCENARIO_NAMES:
        tr = _make(scenario, seed=3, t=6_000)
        head = N // 10
        if scenario == "churn":
            counts = np.bincount(tr.ravel(), minlength=N)
            share = np.sort(counts)[::-1][:head].sum() / tr.size
        else:
            share = (tr < head).mean()
        assert share > 2.5 * 0.1, (scenario, share)


@pytest.mark.parametrize("s", [1, 4])
def test_sample_key_is_placement_independent(s):
    """Sample i is a pure function of (seed, i): generating it alone, or in a
    batch of any size, yields the same stream."""
    dspec = DeviceTraceSpec("churn", N, n_samples=4, trace_len=1_000, seed=9)
    full = _make("churn", seed=9, s=4, t=1_000)
    part = make_traces_device(DeviceTraceSpec("churn", N, n_samples=s, trace_len=1_000, seed=9), device="cpu")
    np.testing.assert_array_equal(part.numpy(), full[:s])
    for i in (0, 3):
        np.testing.assert_array_equal(gen_sample(dspec, sample_key(dspec, i), device="cpu").numpy(), full[i])


def test_stream_chunks_are_pure_functions_of_seed_sample_chunk():
    dspec = DeviceTraceSpec("flash_crowd", N, n_samples=2, trace_len=500, seed=4)
    a = gen_stream_chunk(dspec, 1, 7, device="cpu")
    np.testing.assert_array_equal(a.numpy(), gen_stream_chunk(dspec, 1, 7, device="cpu").numpy())
    assert a.shape == (500,) and a.dtype == torch.int32
    keys = {stream_chunk_key(dspec, s, c) for s in range(3) for c in range(50)} | {sample_key(dspec, s) for s in range(3)}
    assert len(keys) == 153  # no two chunks share a generator
    assert (a.numpy() != gen_stream_chunk(dspec, 1, 8, device="cpu").numpy()).any()


def test_churn_moves_popularity_between_phases():
    tr = _make("churn", seed=2, n=200, s=1, t=10_000, n_phases=2, churn_frac=0.5)[0]
    first, second = np.bincount(tr[:5_000], minlength=200), np.bincount(tr[5_000:], minlength=200)
    assert np.argmax(first) == 0  # the first phase keeps id = rank
    assert (np.argsort(-first)[:20] != np.argsort(-second)[:20]).any()
    # with no churn the ranks are the ids: the stationary trace of the same seed
    np.testing.assert_array_equal(_make("churn", seed=2, n=200, s=1, t=2_000, churn_frac=0.0)[0],
                                  _make("stationary", seed=2, n=200, s=1, t=2_000)[0])


def test_flash_crowd_spikes_hit_cold_ids():
    tr = _make("flash_crowd", seed=1, s=1, t=4_000, n_spikes=1, spike_intensity=1.0, spike_len_frac=0.1)[0]
    cold = tr >= (3 * N) // 4
    ids, counts = np.unique(tr[cold], return_counts=True)
    hot = tr == ids[np.argmax(counts)]
    # one cold id takes 400 consecutive requests: the whole spike
    runs = np.diff(np.flatnonzero(np.diff(np.concatenate([[0], hot.astype(np.int8), [0]]))))[::2]
    assert runs.max() == 400


def test_diurnal_and_multi_tenant_semantics():
    flat = _make("diurnal", seed=1, s=1, t=6_000, alpha_swing=0.0)[0]
    swung = _make("diurnal", seed=1, s=1, t=6_000, alpha_swing=0.9, n_cycles=1)[0]
    assert (swung[:1_500] == 0).mean() > (flat[:1_500] == 0).mean()  # alpha peaks in the first quarter
    tr = _make("multi_tenant", seed=1, s=1, t=6_000, n_tenants=4, weights=(0.7, 0.1, 0.1, 0.1))[0]
    tenant = tr // (N // 4)
    shares = np.bincount(tenant, minlength=4) / tr.size
    assert 0.65 < shares[0] < 0.75 and all(0.07 < x < 0.13 for x in shares[1:])
    groups = workloads.tenant_groups(N, 4)
    np.testing.assert_array_equal(groups[tr], tenant)  # ids fall in their tenant's block


def test_scan_sweeps_walk_the_tail():
    tr = _make("scan", seed=3, s=1, t=8_000, n_sweeps=2, sweep_intensity=1.0, sweep_len_frac=0.1)[0]
    seg, sweep = 4_000, 800
    start = (seg - sweep) // 2
    walk = tr[start:start + sweep]
    assert (walk >= N // 2).all()
    steps = np.diff(walk) % (N - N // 2)
    assert (steps == 1).all()  # consecutive ids, wrapping within the swept span
    np.testing.assert_array_equal(_make("scan", seed=3, s=1, t=2_000, n_sweeps=0)[0],
                                  _make("stationary", seed=3, s=1, t=2_000)[0])


def test_unknown_override_rejected():
    with pytest.raises(ValueError, match="unknown override"):
        DeviceTraceSpec("stationary", N, overrides=(("n_phases", 3),))
    with pytest.raises(ValueError, match="unknown device scenario"):
        DeviceTraceSpec("nope", N)
    with pytest.raises(ValueError, match="churn_frac"):
        _make("churn", churn_frac=1.5)
    with pytest.raises(ValueError, match="n_tenants"):
        _make("multi_tenant", n_tenants=0)


@pytest.mark.parametrize("dist", ["lognormal", "pareto"])
@pytest.mark.parametrize("corr", [0.0, 1.0, -1.0])
def test_object_sizes_contract(dist, corr):
    sizes = object_sizes_device(2_000, dist=dist, corr=corr, seed=3, device="cpu")
    assert sizes.shape == (2_000,) and sizes.dtype == torch.int32
    assert int(sizes.min()) >= 1 and int(sizes.max()) <= 1 << 20
    assert torch.equal(sizes, object_sizes_device(2_000, dist=dist, corr=corr, seed=3, device="cpu"))
    assert not torch.equal(sizes, object_sizes_device(2_000, dist=dist, corr=corr, seed=4, device="cpu"))
    same = object_sizes_device(2_000, dist=dist, corr=0.0, seed=3, device="cpu")
    assert torch.equal(torch.sort(sizes).values, torch.sort(same).values)  # corr only reassigns the sizes
    if corr:
        s = sizes.numpy().astype(np.int64)
        assert (s[:-1] >= s[1:]).all() if corr > 0 else (s[:-1] <= s[1:]).all()
    if dist == "lognormal":
        assert 48 <= float(sizes.float().median()) <= 80  # median 64
    with pytest.raises(ValueError):
        object_sizes_device(10, dist="uniform", device="cpu")
