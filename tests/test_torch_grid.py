"""The port's grid harness against the reference simulator, on the CPU.

``simulate.run_grid(..., device="cpu")`` on a reduced grid must give the CHR,
evictions and metadata that the same cases give through
``jax_cache.simulate_batch`` + ``metadata_entries`` + ``eviction_count``,
exactly (CHR as the float mean of equal integer counts, computed the same way),
for all nine kinds with the grid's options (wlfu's window of 10,000, the
sketch kinds' defaults), and, with the byte-capacity catalogue and budget,
the byte CHR too.
Device fields are ``None`` on the CPU: not measured.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads
from repro.core import jax_cache
from repro.core import zipf as ref_zipf
from repro_torch.core import simulate, zipf
from repro_torch.telemetry import timing

N_SAMPLES, TRACE_LEN = 2, 2_000
CASES = zipf.paper_grid([100, 1000], [0.02, 0.25])


def _reference_case(kind, case, seed, sized=False, byte_budget=False):
    """The case through the reference: (mean CHR, std CHR, mean evictions,
    mean metadata, mean byte CHR or None). ``sized`` takes the byte-capacity
    benchmark's catalogue, ``byte_budget`` its budget of cap objects of mean size."""
    window = simulate.WLFU_WINDOW if kind == "wlfu" else 0
    sizes = workloads.object_sizes(case.n_objects, dist="lognormal", corr=0.5, seed=11, median=64) if sized else None
    cap_b = int(case.cache_size * sizes.mean()) if byte_budget else 0
    spec = jax_cache.PolicySpec(kind=kind, n_objects=case.n_objects, capacity=case.cache_size, window=window,
                                capacity_bytes=cap_b)
    traces = ref_zipf.sample_traces(case.n_objects, N_SAMPLES, TRACE_LEN, seed=seed)
    sz = None if sizes is None else jnp.asarray(sizes)
    hits = np.asarray(jax_cache.simulate_batch(spec, jnp.asarray(traces), None, sz))
    states = jax.vmap(lambda tr: jax_cache.simulate(spec, tr, None, sz)[1])(jnp.asarray(traces))
    byte_chr = None if sizes is None else float(np.mean(
        [sizes[traces[i]][hits[i]].sum() / sizes[traces[i]].sum() for i in range(N_SAMPLES)]))
    chrs, evictions, metadata = [], [], []
    for i in range(N_SAMPLES):
        state = {k: np.asarray(v[i]) for k, v in states.items()}
        chrs.append(int(hits[i].sum()) / TRACE_LEN)
        evictions.append(jax_cache.eviction_count(spec, hits[i], traces[i], state))
        metadata.append(int(jax_cache.metadata_entries(spec, state)))
    return (float(np.mean(chrs)), float(np.std(chrs)), float(np.mean(evictions)), float(np.mean(metadata)),
            byte_chr)


@pytest.mark.parametrize("kind", ["lru", "lfu", "plfu", "plfua", "wlfu", "tinylfu", "plfua_dyn", "arc"])
def test_run_grid_matches_reference(kind):
    seed = 3
    rows = simulate.run_grid(kind, CASES, n_samples=N_SAMPLES, trace_len=TRACE_LEN, seed=seed, device="cpu")
    assert [r.case for r in rows] == CASES
    for row in rows:
        assert row.policy == kind
        got = (row.mean_chr, row.std_chr, row.mean_evictions, row.mean_metadata, row.mean_byte_chr)
        assert got == _reference_case(kind, row.case, seed), row.case
        assert row.device_s is None and row.j_per_request is None


@pytest.mark.parametrize(
    "kind,byte_budget",
    [("gdsf", False), ("gdsf", True), ("lru", True), ("lfu", True), ("plfu", True), ("plfua", True),
     ("plfua_dyn", True)],
)
def test_sized_run_grid_matches_reference(kind, byte_budget):
    """The byte-capacity benchmark's catalogue (and budget): CHR, evictions,
    metadata and byte CHR as the reference gives them."""
    seed = 4
    rows = simulate.run_grid(kind, CASES, n_samples=N_SAMPLES, trace_len=TRACE_LEN, seed=seed, device="cpu",
                             sizing="budget" if byte_budget else "sized")
    for row in rows:
        got = (row.mean_chr, row.std_chr, row.mean_evictions, row.mean_metadata, row.mean_byte_chr)
        assert got == _reference_case(kind, row.case, seed, sized=True, byte_budget=byte_budget), row.case


def test_run_grid_rejects_an_unknown_sizing():
    with pytest.raises(ValueError, match="sizing"):
        simulate.run_grid("gdsf", CASES[:1], n_samples=1, trace_len=10, device="cpu", sizing="bytes")


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
