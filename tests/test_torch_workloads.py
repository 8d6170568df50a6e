"""The port's copies of the workload generators against the reference's.

``repro_torch.workloads.generators`` keeps its own copy of the six host
scenarios (``stationary``, ``churn``, ``flash_crowd``, ``diurnal``,
``multi_tenant``, ``scan``), ``tenant_groups`` and ``object_sizes`` (the port
imports nothing of ``repro``); each must give the reference's arrays bit for
bit (ids, sizes and dtypes) and raise the reference's errors, and
``repro_torch.workloads.make_traces`` must build every scenario as the
reference's does. ``TraceSpec`` and ``register_scenario`` are the
reference's too.
"""
import dataclasses

import numpy as np
import pytest

from repro import workloads as ref_workloads
from repro.workloads import generators as ref
from repro_torch import workloads as port_workloads
from repro_torch.workloads import generators as port


@pytest.mark.parametrize("n,s,t,seed", [(100, 2, 500, 0), (6_000, 3, 2_000, 33), (1, 1, 10, 5)])
def test_stationary_matches_reference(n, s, t, seed):
    got, want = port.stationary(n, s, t, seed=seed), ref.stationary(n, s, t, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        dict(n_sweeps=6, sweep_len_frac=0.06),
        dict(n_sweeps=0),
        dict(n_sweeps=1, sweep_intensity=1.0, scan_lo_frac=0.0),
        dict(n_sweeps=3, sweep_len_frac=0.2, sweep_intensity=0.3, scan_lo_frac=0.9, alpha=0.8),
    ],
)
def test_scan_matches_reference(kw):
    got = port.scan(600, 3, 12_000, seed=33, **kw)
    want = ref.scan(600, 3, 12_000, seed=33, **kw)
    assert got.dtype == want.dtype and got.shape == (3, 12_000)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("corr", [-1.0, -0.5, 0.0, 0.5, 1.0])
@pytest.mark.parametrize("dist", ["lognormal", "pareto"])
def test_object_sizes_match_reference(dist, corr):
    for kw in (dict(seed=11), dict(seed=3, median=8, max_size=64), dict(seed=0, sigma=0.5, shape=2.5)):
        got = port.object_sizes(5_000, dist=dist, corr=corr, **kw)
        want = ref.object_sizes(5_000, dist=dist, corr=corr, **kw)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_size_dists_match_reference():
    assert port.SIZE_DISTS == ref.SIZE_DISTS


@pytest.mark.parametrize(
    "fn,kw,match",
    [
        ("object_sizes", dict(dist="uniform"), "unknown size dist"),
        ("object_sizes", dict(corr=1.5), "corr"),
        ("scan", dict(n_sweeps=-1), "n_sweeps"),
        ("scan", dict(sweep_intensity=1.5), "sweep_intensity"),
        ("scan", dict(scan_lo_frac=1.0), "scan_lo_frac"),
        ("churn", dict(churn_frac=1.5), "churn_frac"),
        ("multi_tenant", dict(n_tenants=0), "n_tenants"),
        ("multi_tenant", dict(n_tenants=2, weights=(1.0,)), "weights"),
        ("tenant_groups", dict(n_tenants=101), "n_tenants"),
    ],
)
def test_bad_arguments_raise_as_the_reference(fn, kw, match):
    for module in (port, ref):
        with pytest.raises(ValueError, match=match):
            getattr(module, fn)(100, **kw)


@pytest.mark.parametrize(
    "fn,kw",
    [
        ("churn", {}),
        ("churn", dict(n_phases=3, churn_frac=0.8, alpha=0.9)),
        ("churn", dict(churn_frac=0.0)),
        ("flash_crowd", {}),
        ("flash_crowd", dict(n_spikes=5, spike_len_frac=0.1, spike_intensity=0.9)),
        ("diurnal", {}),
        ("diurnal", dict(n_cycles=3, alpha_swing=1.2, n_chunks=7)),
        ("multi_tenant", {}),
        ("multi_tenant", dict(n_tenants=3, weights=(0.5, 0.3, 0.2))),
        ("multi_tenant", dict(n_tenants=1)),
    ],
)
def test_scenario_generators_match_reference(fn, kw):
    for n, s, t, seed in ((600, 3, 5_000, 7), (101, 2, 997, 0)):
        got = getattr(port, fn)(n, s, t, seed=seed, **kw)
        want = getattr(ref, fn)(n, s, t, seed=seed, **kw)
        assert got.dtype == want.dtype == np.int32 and got.shape == (s, t)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k", [(100, 4), (103, 4), (7, 7), (50, 1)])
def test_tenant_groups_match_reference(n, k):
    got, want = port.tenant_groups(n, k), ref.tenant_groups(n, k)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_make_traces_matches_reference_for_every_scenario():
    assert port_workloads.SCENARIO_NAMES == ref_workloads.SCENARIO_NAMES
    for scenario in port_workloads.SCENARIO_NAMES:
        got = port_workloads.make_traces(scenario, 300, 2, 1_500, seed=4)
        want = ref_workloads.make_traces(scenario, 300, 2, 1_500, seed=4)
        np.testing.assert_array_equal(got, want)
    got = port_workloads.make_traces("multi_tenant", 300, 2, 800, seed=1, n_tenants=3)
    np.testing.assert_array_equal(got, ref_workloads.make_traces("multi_tenant", 300, 2, 800, seed=1, n_tenants=3))
    with pytest.raises(ValueError, match="unknown scenario"):
        port_workloads.make_traces("nope", 10)


@pytest.mark.parametrize("scenario,overrides", [("flash_crowd", dict(n_spikes=1)), ("scan", dict(n_sweeps=2)),
                                                ("stationary", {})])
def test_trace_spec_matches_reference(scenario, overrides):
    """``TraceSpec`` is the reference's: the same fields, sorted overrides,
    equality and hash, and ``build`` gives the reference's arrays."""
    port = port_workloads.TraceSpec(scenario, 500, 2, 1_500, seed=1).with_overrides(**overrides)
    ref = ref_workloads.TraceSpec(scenario, 500, 2, 1_500, seed=1).with_overrides(**overrides)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    assert port == port_workloads.TraceSpec(scenario, 500, 2, 1_500, 1, tuple(sorted(overrides.items())))
    assert hash(port) == hash(port_workloads.TraceSpec(scenario, 500, 2, 1_500, 1, tuple(sorted(overrides.items()))))
    np.testing.assert_array_equal(port.build(), ref.build())
    defaults = port_workloads.TraceSpec(scenario, 7)
    assert (defaults.n_samples, defaults.trace_len, defaults.seed, defaults.overrides) == \
        (ref_workloads.TraceSpec(scenario, 7).n_samples, ref_workloads.TraceSpec(scenario, 7).trace_len, 0, ())


def test_trace_spec_and_register_scenario_refuse_as_the_reference():
    for mod in (port_workloads, ref_workloads):
        with pytest.raises(ValueError, match="unknown scenario 'nope'"):
            mod.TraceSpec("nope", 10)
        with pytest.raises(ValueError, match="scenario 'stationary' already registered"):
            mod.register_scenario("stationary", mod.stationary)


def test_register_scenario_adds_a_generator(monkeypatch):
    """A registered generator is built by name, by ``make_traces`` and by a
    ``TraceSpec``, in both packages alike."""
    def ramp(n_objects, n_samples, trace_len, *, seed=0, step=1):
        return (np.arange(n_samples * trace_len).reshape(n_samples, trace_len) * step + seed) % n_objects

    for mod in (port_workloads, ref_workloads):
        monkeypatch.setitem(mod.SCENARIOS, "ramp", None)
        del mod.SCENARIOS["ramp"]
        mod.register_scenario("ramp", ramp)
    got = port_workloads.TraceSpec("ramp", 50, 2, 30, seed=3).with_overrides(step=7).build()
    want = ref_workloads.TraceSpec("ramp", 50, 2, 30, seed=3).with_overrides(step=7).build()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (2, 30)
    np.testing.assert_array_equal(port_workloads.make_traces("ramp", 50, 2, 30, seed=3), ramp(50, 2, 30, seed=3))
