"""The port's copies of the reference's numpy and spec modules agree with it.

registry, PolicySpec, the sketch size conventions, zipf and energy are copied
into ``repro_torch`` (it imports nothing of ``repro``); these tests pin each
copy to its reference.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import energy as ref_energy
from repro.core import jax_cache, registry as ref_registry, sketch as ref_sketch, zipf as ref_zipf
from repro_torch.core import energy, registry, sketch, torch_cache, zipf

_FLAGS = ("reference", "jax", "pallas", "sketch", "telemetry", "grouped_telemetry", "size_aware")


@pytest.mark.parametrize(
    "filters",
    [{}] + [{flag: value} for flag, value in itertools.product(_FLAGS, (True, False))],
)
def test_registry_names_match(filters):
    assert registry.names(**filters) == ref_registry.names(**filters)


def test_registry_policies_and_constants_match():
    assert [dataclasses.asdict(p) for p in registry.POLICIES] == [
        dataclasses.asdict(p) for p in ref_registry.POLICIES
    ]
    assert registry.GDSF_SHIFT == ref_registry.GDSF_SHIFT
    assert registry.DEFAULT_MAX_VICTIMS == ref_registry.DEFAULT_MAX_VICTIMS
    assert registry.info("plfua") == registry.POLICIES[3]
    with pytest.raises(ValueError, match="unknown policy"):
        registry.info("nope")


def test_policy_spec_fields_match():
    port = [(f.name, f.default) for f in dataclasses.fields(torch_cache.PolicySpec)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jax_cache.PolicySpec)]
    assert port == ref


_SPECS = [
    dict(kind=kind, n_objects=n, capacity=cap, **extra)
    for kind in ref_registry.names(jax=True)
    for n, cap in ((64, 9), (10, 40), (100_000, 2_000))
    for extra in (
        {},
        {"hot_size": 5} if kind in ("plfua", "plfua_dyn") else {"window": 7},
        {"refresh": 11, "sketch_width": 300},
        {"capacity_bytes": 500, "max_victims": 3} if kind != "arc" else {},
        {"doorkeeper": 64} if kind == "tinylfu" else {},
    )
    if kind != "wlfu" or "window" in extra
]


@pytest.mark.parametrize("kw", _SPECS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_policy_spec_effective_rules_match(kw):
    port, ref = torch_cache.PolicySpec(**kw), jax_cache.PolicySpec(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("size_aware", "effective_max_victims", "effective_hot", "effective_window",
                 "effective_refresh", "effective_sketch_width"):
        assert getattr(port, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize(
    "kw",
    [
        dict(kind="nope"),
        dict(kind="wlfu"),
        dict(kind="wlfu", window=0),
        dict(kind="lfu", doorkeeper=-1),
        dict(kind="lfu", doorkeeper=64),
        dict(kind="lfu", capacity_bytes=-1),
        dict(kind="arc", capacity_bytes=64),
        dict(kind="lfu", max_victims=-1),
        dict(kind="lfu", max_victims=2),
    ],
)
def test_policy_spec_value_errors_match(kw):
    with pytest.raises(ValueError) as ref:
        jax_cache.PolicySpec(n_objects=32, capacity=4, **kw)
    with pytest.raises(ValueError) as port:
        torch_cache.PolicySpec(n_objects=32, capacity=4, **kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("capacity", [0, 1, 9, 63, 64, 100, 2_000, 25_000])
def test_sketch_conventions_match(capacity):
    assert sketch.DEPTH == ref_sketch.DEPTH
    for name in ("default_width", "default_window", "default_refresh", "default_doorkeeper"):
        assert getattr(sketch, name)(capacity) == getattr(ref_sketch, name)(capacity), name


@pytest.mark.parametrize("n,s,t,seed", [(100, 3, 500, 0), (46_416, 2, 1_000, 3), (100_000, 12, 200, 11)])
def test_zipf_traces_match_bit_for_bit(n, s, t, seed):
    port = zipf.sample_traces(n, n_samples=s, trace_len=t, seed=seed)
    ref = ref_zipf.sample_traces(n, n_samples=s, trace_len=t, seed=seed)
    assert port.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(zipf.zipf_probs(n), ref_zipf.zipf_probs(n))


def test_zipf_grid_matches():
    port, ref = zipf.paper_grid(), ref_zipf.paper_grid()
    assert len(port) == len(ref) == 60
    assert [(c.n_objects, c.rate, c.cache_size, c.hot_size) for c in port] == [
        (c.n_objects, c.rate, c.cache_size, c.hot_size) for c in ref
    ]
    np.testing.assert_array_equal(zipf.paper_object_counts(), ref_zipf.paper_object_counts())
    np.testing.assert_array_equal(zipf.paper_cache_rates(), ref_zipf.paper_cache_rates())
    assert (zipf.PAPER_ALPHA, zipf.PAPER_TRACE_LEN, zipf.PAPER_NUM_SAMPLES) == (
        ref_zipf.PAPER_ALPHA, ref_zipf.PAPER_TRACE_LEN, ref_zipf.PAPER_NUM_SAMPLES)
    reduced = zipf.paper_grid([100, 1000], [0.02, 0.25])
    assert reduced == [zipf.GridCase(n, r) for n in (100, 1000) for r in (0.02, 0.25)]
    np.testing.assert_array_equal(zipf.synthetic_isp_trace(500), ref_zipf.synthetic_isp_trace(500))


def test_energy_matches():
    assert energy.CPU_CORE_POWER_W == ref_energy.CPU_CORE_POWER_W
    for s in (0.0, 0.5, 12.25):
        assert energy.mgmt_energy_j(s) == ref_energy.mgmt_energy_j(s)
    assert energy.device_energy_j(2.0, 700.0) == 1400.0
    with pytest.raises(ValueError, match="power_w"):
        energy.device_energy_j(1.0, 0.0)
