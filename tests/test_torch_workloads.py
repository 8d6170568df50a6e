"""The port's copies of the workload generators against the reference's.

``repro_torch.workloads.generators`` keeps its own copy of ``stationary``,
``scan`` and ``object_sizes`` (the port imports nothing of ``repro``); each
must give the reference's arrays bit for bit (ids, sizes and dtypes) and
raise the reference's errors.
"""
import numpy as np
import pytest

from repro.workloads import generators as ref
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
    ],
)
def test_bad_arguments_raise_as_the_reference(fn, kw, match):
    for module in (port, ref):
        with pytest.raises(ValueError, match=match):
            getattr(module, fn)(100, **kw)
