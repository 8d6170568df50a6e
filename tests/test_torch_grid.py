"""The port's grid harness against the reference simulator, on the CPU.

``simulate.run_grid(..., device="cpu")`` on a reduced grid must give the CHR,
evictions and metadata that the same cases give through
``jax_cache.simulate_batch`` + ``metadata_entries`` + ``eviction_count``,
exactly (CHR as the float mean of equal integer counts, computed the same way),
for the seven ported kinds with the grid's options (wlfu's window of 10,000,
the sketch kinds' defaults).
Device fields are ``None`` on the CPU: not measured.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_cache
from repro.core import zipf as ref_zipf
from repro_torch.core import simulate, zipf
from repro_torch.telemetry import timing

N_SAMPLES, TRACE_LEN = 2, 2_000
CASES = zipf.paper_grid([100, 1000], [0.02, 0.25])


def _reference_case(kind, case, seed):
    window = simulate.WLFU_WINDOW if kind == "wlfu" else 0
    spec = jax_cache.PolicySpec(kind=kind, n_objects=case.n_objects, capacity=case.cache_size, window=window)
    traces = ref_zipf.sample_traces(case.n_objects, N_SAMPLES, TRACE_LEN, seed=seed)
    hits = np.asarray(jax_cache.simulate_batch(spec, jnp.asarray(traces)))
    states = jax.vmap(lambda tr: jax_cache.simulate(spec, tr)[1])(jnp.asarray(traces))
    chrs, evictions, metadata = [], [], []
    for i in range(N_SAMPLES):
        state = {k: np.asarray(v[i]) for k, v in states.items()}
        chrs.append(int(hits[i].sum()) / TRACE_LEN)
        evictions.append(jax_cache.eviction_count(spec, hits[i], traces[i], state))
        metadata.append(int(jax_cache.metadata_entries(spec, state)))
    return (float(np.mean(chrs)), float(np.std(chrs)), float(np.mean(evictions)), float(np.mean(metadata)))


@pytest.mark.parametrize("kind", ["lru", "lfu", "plfu", "plfua", "wlfu", "tinylfu", "plfua_dyn"])
def test_run_grid_matches_reference(kind):
    seed = 3
    rows = simulate.run_grid(kind, CASES, n_samples=N_SAMPLES, trace_len=TRACE_LEN, seed=seed, device="cpu")
    assert [r.case for r in rows] == CASES
    for row in rows:
        assert row.policy == kind
        got = (row.mean_chr, row.std_chr, row.mean_evictions, row.mean_metadata)
        assert got == _reference_case(kind, row.case, seed), row.case
        assert row.device_s is None and row.j_per_request is None


def test_run_grid_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate.run_grid("lfu", CASES[:1], n_samples=1, trace_len=10)


def test_measure_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.measure(lambda: calls.append(1), steps=1)
    assert calls == []
    with pytest.raises(ValueError, match="steps"):
        timing.measure(lambda: None, steps=0)


def test_timing_derived_numbers():
    tm = timing.Timing(steps=1_000, repeats=3, compile_s=1.0, execute_s=0.5, mean_execute_s=0.6,
                       power_w=700.0, card="NVIDIA H100 80GB HBM3, 700.00 W")
    assert tm.steps_per_s == 2_000.0
    assert tm.us_per_step == 500.0
    assert tm.j_per_step == 0.5 * 700.0 / 1_000
