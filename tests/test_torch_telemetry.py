"""The port's windowed telemetry against the reference's, ungrouped.

* The series builders of ``repro_torch.telemetry.spec`` (torch) against
  ``repro.telemetry.spec`` (numpy) on random events: the window edges
  (W = 1, W not dividing T, W > T), int32 wrap of the sums, the chunk-to-window
  map of plfua_dyn's refreshes.
* ``torch_cache.simulate_batch(telemetry=TelemetrySpec(W))`` against
  ``jax_cache.simulate_batch``: all nine kinds on stationary and churn traces
  with W in {1, 7, T}, byte mode for the eight budget-capable kinds,
  plfua_dyn with a partial tail period, tinylfu aging mid-trace. Telemetry
  changes no primary output.
* The port's ``ops.cache_sim(device="cpu", telemetry_window=W)`` against the
  reference kernel in interpret mode (lru, tinylfu, plfua_dyn, arc, gdsf
  under a budget).
* ``timing.profile`` (``measure``'s ``profile_dir``) writes its trace on the CPU.

Everything compared is an integer, so the tolerance is exact. The grouped
layout is in tests/test_torch_telemetry_groups.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as ref_telemetry
from repro import workloads as ref_workloads
from repro.core import jax_cache
from repro.kernels.cache_sim import ops as ref_ops
from repro.telemetry import spec as ref_spec
from repro_torch import telemetry as port_telemetry
from repro_torch import workloads
from repro_torch.core import torch_cache
from repro_torch.kernels.cache_sim import ops
from repro_torch.telemetry import spec as port_spec
from repro_torch.telemetry import timing

KINDS = ("lru", "lfu", "plfu", "plfua", "wlfu", "tinylfu", "plfua_dyn", "gdsf", "arc")
BYTE_KINDS = ("lru", "lfu", "plfu", "plfua", "wlfu", "tinylfu", "plfua_dyn", "gdsf")
# small windows, sketches and refresh periods: the ring wraps, tinylfu ages
# (every 50 requests) and plfua_dyn refreshes (every 111: 500 % 111 = 56, so
# the tail period never fires) within the 500-request traces
KIND_KW = {
    "wlfu": dict(window=16),
    "tinylfu": dict(window=50, sketch_width=64),
    "plfua_dyn": dict(refresh=111, sketch_width=64),
}
N, CAP, S, T = 60, 6, 2, 500


def _specs(kind, **kw):
    kw = {**KIND_KW.get(kind, {}), **kw}
    return torch_cache.PolicySpec(kind, N, CAP, **kw), jax_cache.PolicySpec(kind, N, CAP, **kw)


def _assert_equal(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    np.testing.assert_array_equal(port, ref)


# ------------------------------------------------------------------ builders
def test_metric_names_and_spec_validation_match_reference():
    assert port_spec.METRICS == ref_spec.METRICS
    assert port_spec.N_METRICS == ref_spec.N_METRICS == 11
    assert port_spec.METRIC_INDEX == ref_spec.METRIC_INDEX
    for kw, match in ((dict(window=0), "window"), (dict(window=4, n_groups=-1), "n_groups")):
        for module in (port_spec, ref_spec):
            with pytest.raises(ValueError, match=match):
                module.TelemetrySpec(**kw)
    assert port_spec.TelemetrySpec(7).n_windows(50) == ref_spec.TelemetrySpec(7).n_windows(50) == 8
    for module in (port_spec, ref_spec):
        with pytest.raises(ValueError, match="trace_len"):
            module.n_windows(0, 3)


@pytest.mark.parametrize("t,w", [(50, 1), (50, 7), (50, 10), (50, 50), (50, 80), (1, 1), (1, 5)])
def test_bucket_helpers_match_reference(t, w):
    rng = np.random.default_rng(t * 100 + w)
    ev = rng.integers(0, 5, size=(3, t)).astype(np.int32)
    occ = np.cumsum(rng.integers(-1, 2, size=(3, t)), axis=-1).astype(np.int32)
    _assert_equal(port_spec.window_sizes(t, w), ref_spec.window_sizes(t, w))
    _assert_equal(port_spec.bucket_sum(torch.as_tensor(ev), w), ref_spec.bucket_sum(ev, w))
    _assert_equal(port_spec.bucket_end(torch.as_tensor(occ), w), ref_spec.bucket_end(occ, w))
    _assert_equal(port_spec.bucket_sum(torch.as_tensor(ev > 2), w), ref_spec.bucket_sum(ev > 2, w))


def test_bucket_sum_wraps_as_int32():
    """Byte columns are int32 sums: a window of large sizes wraps as the
    reference's (and the kernel's) int32 accumulation does."""
    big = np.full((2, 9), 2**30 + 7, np.int32)
    _assert_equal(port_spec.bucket_sum(torch.as_tensor(big), 4), ref_spec.bucket_sum(big, 4))
    assert int(port_spec.bucket_sum(torch.as_tensor(big), 4)[0, 0]) == 4 * (2**30 + 7) - 2**32
    assert int(port_spec.bucket_sum(torch.as_tensor(big), 2)[0, 0]) < 0


@pytest.mark.parametrize("n_chunks,chunk_len,t,w", [(5, 111, 500, 7), (4, 97, 400, 1), (3, 50, 150, 200),
                                                    (6, 10, 55, 9)])
def test_chunk_window_matrix_matches_reference(n_chunks, chunk_len, t, w):
    _assert_equal(port_spec.chunk_window_matrix(n_chunks, chunk_len, t, w),
                  ref_spec.chunk_window_matrix(n_chunks, chunk_len, t, w))


@pytest.mark.parametrize("with_optional", [False, True])
def test_series_from_run_matches_reference(with_optional):
    """Random events through both builders, every optional series included
    (active, offers, aging, the chunk events and the byte columns)."""
    rng = np.random.default_rng(5)
    t, w, chunk = 95, 8, 20
    ev = dict(
        hits=rng.random((3, t)) < 0.5,
        fills=rng.random((3, t)) < 0.3,
        evictions=rng.integers(0, 3, (3, t)).astype(np.int32),
        occupancy=rng.integers(0, 9, (3, t)).astype(np.int32),
    )
    if with_optional:
        ev.update(
            active=rng.random((3, t)) < 0.8,
            offers=rng.random((3, t)) < 0.4,
            aging=rng.random((3, t)) < 0.05,
            fired=rng.random((3, 5)) < 0.7,
            churn=rng.integers(0, 6, (3, 5)).astype(np.int32),
            hit_bytes=rng.integers(0, 2**29, (3, t)).astype(np.int32),
            miss_bytes=rng.integers(0, 2**29, (3, t)).astype(np.int32),
        )
    kw = dict(chunk_len=chunk) if with_optional else {}
    ref = ref_spec.series_from_run(w, t, **ev, **kw)
    port = port_spec.series_from_run(w, t, **{k: torch.as_tensor(v) for k, v in ev.items()}, **kw)
    _assert_equal(port, ref)
    per_step = {k: torch.as_tensor(v) for k, v in ev.items() if k not in ("fired", "churn")}
    with pytest.raises(ValueError, match="chunk_len"):
        port_spec.series_from_run(w, t, **per_step, fired=torch.ones(3, 5, dtype=torch.bool),
                                  churn=torch.zeros(3, 5))


def test_exports_match_reference():
    names = {n for n in ref_telemetry.__all__ if hasattr(ref_spec, n)}
    assert names <= set(port_telemetry.__all__)


# --------------------------------------------------------------- simulator
def _traces(scenario, seed=9, n=N, s=S, t=T):
    return ref_workloads.make_traces(scenario, n, n_samples=s, trace_len=t, seed=seed)


def _jax_series(spec, traces, telemetry, sizes=None, groups=None):
    ref_hits, series = jax_cache.simulate_batch(
        spec, jnp.asarray(traces), telemetry, None if sizes is None else jnp.asarray(sizes),
        None if groups is None else jnp.asarray(groups))
    return np.asarray(ref_hits), np.asarray(series)


@pytest.mark.parametrize("scenario", ["stationary", "churn"])
@pytest.mark.parametrize("kind", KINDS)
def test_series_matches_jax(kind, scenario):
    """Each kind's series with W = 1, 7 and T (one window), bit for bit."""
    port, ref = _specs(kind)
    traces = _traces(scenario)
    for w in (1, 7, T):
        hits, _, series = torch_cache.simulate_batch(port, traces, port_telemetry.TelemetrySpec(w), device="cpu")
        ref_hits, ref_series = _jax_series(ref, traces, ref_telemetry.TelemetrySpec(w))
        _assert_equal(hits, ref_hits)
        _assert_equal(series, ref_series)
        assert series.shape == (S, -(-T // w), port_spec.N_METRICS)
        # the hits column sums to the hit count, requests to the window sizes
        assert torch.equal(series[..., 1].sum(dim=1), hits.sum(dim=1).to(torch.int32).long())
        assert torch.equal(series[0, :, 0], port_spec.window_sizes(T, w))


@pytest.mark.parametrize("kind", BYTE_KINDS)
def test_byte_mode_series_matches_jax(kind):
    """Under a byte budget of 8 objects of mean size: evictions count every
    victim of an insert, occupancy stays an object count, and the byte
    columns carry the requests' sizes."""
    sizes = ref_workloads.object_sizes(N, dist="pareto", corr=0.5, seed=11, median=8)
    budget = int(8 * sizes.mean())
    port, ref = _specs(kind, capacity_bytes=budget)
    traces = _traces("stationary", seed=21)
    hits, state, series = torch_cache.simulate_batch(port, traces, port_telemetry.TelemetrySpec(9),
                                                     sizes=sizes, device="cpu")
    ref_hits, ref_series = _jax_series(ref, traces, ref_telemetry.TelemetrySpec(9), sizes)
    _assert_equal(hits, ref_hits)
    _assert_equal(series, ref_series)
    # inserts - evictions = the final occupancy, and the last window's occupancy is it
    evictions = series[..., port_spec.METRIC_INDEX["evictions"]].sum(dim=1)
    assert torch.equal(state["inserts"].long() - evictions, state["count"].long())
    assert torch.equal(series[:, -1, port_spec.METRIC_INDEX["occupancy"]], state["count"])


def test_unsized_kind_with_a_sizes_row_matches_jax():
    """As the reference's simulator, the byte columns read a sizes row
    whenever it is given, even for a kind that does not consult it."""
    sizes = ref_workloads.object_sizes(N, seed=2)
    port, ref = _specs("lru")
    traces = _traces("stationary", seed=4)
    _, _, series = torch_cache.simulate_batch(port, traces, port_telemetry.TelemetrySpec(7), sizes=sizes,
                                              device="cpu")
    _, ref_series = _jax_series(ref, traces, ref_telemetry.TelemetrySpec(7), sizes)
    _assert_equal(series, ref_series)
    assert not torch.equal(series[..., 9], series[..., 1])


def test_plfua_dyn_partial_tail_and_refresh_rows():
    """T = 600, refresh 97: six refreshes, each in the window of position
    (c+1)*97 - 1; the 18-request tail never fires. Churn is counted."""
    port, ref = _specs("plfua_dyn", refresh=97)
    traces = _traces("churn", seed=13, t=600)
    for w in (1, 50, 601):
        _, state, series = torch_cache.simulate_batch(port, traces, port_telemetry.TelemetrySpec(w), device="cpu")
        _, ref_series = _jax_series(ref, traces, ref_telemetry.TelemetrySpec(w))
        _assert_equal(series, ref_series)
        refreshes = series[..., port_spec.METRIC_INDEX["refreshes"]]
        assert refreshes.sum(dim=1).tolist() == [600 // 97] * S
        if w == 1:
            assert refreshes[0].nonzero().flatten().tolist() == [(c + 1) * 97 - 1 for c in range(6)]
    assert int(series[..., port_spec.METRIC_INDEX["hot_churn"]].sum()) > 0


def test_tinylfu_aging_refreshes_mid_trace():
    """tinylfu's aging every 50 requests: one refresh in the window of every
    50th request, with and without the doorkeeper."""
    for extra in ({}, dict(doorkeeper=64)):
        port, ref = _specs("tinylfu", **extra)
        traces = _traces("stationary", seed=17)
        _, _, series = torch_cache.simulate_batch(port, traces, port_telemetry.TelemetrySpec(25), device="cpu")
        _, ref_series = _jax_series(ref, traces, ref_telemetry.TelemetrySpec(25))
        _assert_equal(series, ref_series)
        assert series[0, :, port_spec.METRIC_INDEX["refreshes"]].tolist() == [0, 1] * (T // 50)


@pytest.mark.parametrize("kind", KINDS)
def test_telemetry_changes_no_primary_output(kind):
    """The instrumented run's hits and final state equal the plain run's,
    and the single-trace ``simulate`` returns the batch's first series."""
    port, _ = _specs(kind)
    traces = _traces("churn", seed=6)
    hits, state = torch_cache.simulate_batch(port, traces, device="cpu")
    t_hits, t_state, series = torch_cache.simulate_batch(port, traces, port_telemetry.TelemetrySpec(11),
                                                         device="cpu")
    assert torch.equal(hits, t_hits)
    assert set(state) == set(t_state)
    for k in state:
        assert torch.equal(state[k], t_state[k]), k
    one_hits, one_state, one_series = torch_cache.simulate(port, traces[0], port_telemetry.TelemetrySpec(11),
                                                           device="cpu")
    assert torch.equal(one_hits, hits[0]) and torch.equal(one_series, series[0])
    assert torch.equal(one_state["in_cache"], state["in_cache"][0])


def test_telemetry_options_raise():
    port, _ = _specs("lfu")
    traces = _traces("stationary")
    with pytest.raises(ValueError, match="groups catalogue"):
        torch_cache.simulate_batch(port, traces, port_telemetry.TelemetrySpec(5, n_groups=2), device="cpu")
    with pytest.raises(ValueError, match=r"groups must have shape \(60,\)"):
        torch_cache.simulate_batch(port, traces, port_telemetry.TelemetrySpec(5, n_groups=2),
                                   groups=np.zeros(59, np.int32), device="cpu")
    with pytest.raises(TypeError, match="TelemetrySpec"):
        torch_cache.simulate_batch(port, traces, ref_telemetry.TelemetrySpec(5), device="cpu")


# ----------------------------------------------------------- kernel entry
OPS_CASES = [
    ("lru", {}),
    ("tinylfu", dict(window=50, sketch_width=64)),
    ("plfua_dyn", dict(refresh=111, sketch_width=64)),
    ("arc", {}),
    ("gdsf", "budget"),
]


@pytest.mark.parametrize("kind,kw", OPS_CASES)
def test_ops_series_matches_reference_kernel(kind, kw):
    """The port's CPU entry point against the reference kernel (interpret
    mode): the fourth output, and the first three unchanged by telemetry."""
    if kw == "budget":
        sizes = ref_workloads.object_sizes(N, dist="lognormal", corr=0.5, seed=11, median=16)
        kw = dict(sizes=sizes, capacity_bytes=int(CAP * sizes.mean()))
    traces = _traces("stationary", seed=31, t=300)
    call = dict(kind=kind, n_objects=N, capacity=CAP, telemetry_window=13, **kw)
    ref = ref_ops.cache_sim(traces, interpret=True, **call)
    port = ops.cache_sim(traces, device="cpu", **call)
    assert len(port) == len(ref) == 4
    for a, b in zip(port, ref):
        _assert_equal(a, b)
    off = ops.cache_sim(traces, device="cpu", **{k: v for k, v in call.items() if k != "telemetry_window"})
    for a, b in zip(off, port[:3]):
        assert torch.equal(a, b)
    outs = ops.cache_sim_outputs(traces, device="cpu", **call)
    assert torch.equal(outs["series"], port[3])


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(telemetry_window=-1), "telemetry_window"),
        (dict(n_groups=-1), "n_groups"),
        (dict(n_groups=2, groups=np.zeros(32, np.int32)), "set telemetry_window"),
        (dict(telemetry_window=4, n_groups=2), "groups catalogue"),
        (dict(telemetry_window=4, n_groups=2, groups=np.zeros(31, np.int32)), r"groups must have shape \(32,\)"),
        (dict(telemetry_window=4, n_groups=2, groups=np.full(32, 2, np.int32)), r"groups must lie in \[0, 2\)"),
        (dict(telemetry_window=4, n_groups=2, groups=np.full(32, -1, np.int32)), r"groups must lie in \[0, 2\)"),
    ],
)
def test_ops_telemetry_options_raise(kw, match):
    """The reference's option rules, plus the group row's range: the kernel
    indexes its series by group."""
    traces = np.zeros((1, 16), np.int32)
    with pytest.raises(ValueError, match=match):
        ops.cache_sim(traces, kind="lfu", n_objects=32, capacity=4, device="cpu", **kw)


def test_profile_writes_its_trace_on_the_cpu(tmp_path):
    """``measure``'s ``profile_dir`` capture: the Chrome trace is written;
    with no card there is no device time, so no idle share."""
    trace = timing.profile(lambda: workloads.make_traces("churn", 50, 2, 200), profile_dir=tmp_path / "prof")
    assert trace.path.exists() and trace.path.stat().st_size > 0
    assert trace.path.parent == tmp_path / "prof"
    if not torch.cuda.is_available():
        assert trace.kernels == 0 and trace.idle_share is None
    assert timing._busy_and_span([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == (4.0, 6.0)


@pytest.mark.parametrize("cpu_seconds,steps", [(1.0, 10), (0.25, 100_000), (3.5e-3, 7)])
def test_module_j_per_step_matches_reference(cpu_seconds, steps):
    """``telemetry.j_per_step`` (management J a request from a CPU interval)
    is the reference's function, exported from the package as the
    reference's is; ``Timing.j_per_step`` stays the device's J at the power
    limit."""
    want = ref_telemetry.j_per_step(cpu_seconds, steps)
    assert port_telemetry.j_per_step(cpu_seconds, steps) == timing.j_per_step(cpu_seconds, steps) == want
    assert "j_per_step" in port_telemetry.__all__ and "j_per_step" in ref_telemetry.__all__
