"""The CUDA kernel and the grid harness on the card, against the plain version.

Every test here is marked ``cuda`` and skips where there is no card; the check
happens in a fixture when a test runs, never while the module is imported. The
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``tests/test_torch_cache_sim.py`` holds the kernel to the plain version and to
the JAX reference on the small shapes. Everything compared is an integer, so
the tolerance is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import simulate, zipf
from repro_torch.kernels.cache_sim import cache_sim as port_kernel
from repro_torch.kernels.cache_sim import ops
from repro_torch.telemetry import timing
from repro_torch.workloads import generators


@pytest.fixture
def cuda_device():
    """The card, decided when a test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _traces(n, s, t, device, seed=100):
    traces = np.stack([zipf.sample_trace(n, t, seed=seed + i) for i in range(s)])
    return torch.as_tensor(traces, device=device)


def _assert_equal(got, want):
    for a, b in zip(got, want):
        assert a.is_cuda and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# a heavy-tailed catalogue for the 5,000 ids below, and a budget of 40
# objects of mean size (both catalogues of the byte-capacity benchmark)
LOGNORMAL = generators.object_sizes(5000, dist="lognormal", corr=0.5, seed=11, median=64)
PARETO = generators.object_sizes(5000, dist="pareto", corr=0.5, seed=11, median=64)
BUDGET = dict(capacity_bytes=int(40 * LOGNORMAL.mean()), sizes=LOGNORMAL)
# options that make the ring wrap, the sketch age and the hot set refresh
# several times within the 3,000-request traces below
ABOVE_ONE_BLOCK = [
    ("lru", {}), ("lfu", {}), ("plfu", {}), ("plfua", {}),
    ("wlfu", dict(window=500)),
    ("tinylfu", dict(window=400)),
    ("tinylfu", dict(window=400, doorkeeper=320)),
    ("plfua_dyn", dict(refresh=700)),
    ("plfua_dyn", dict(refresh=500, hot_size=4_000, sketch_width=300)),
    ("gdsf", dict(sizes=LOGNORMAL)),
    ("gdsf", {}),
    ("lru", BUDGET), ("lfu", BUDGET), ("plfu", BUDGET), ("plfua", BUDGET), ("gdsf", BUDGET),
    ("plfua_dyn", dict(refresh=700, **BUDGET)),
    ("gdsf", dict(capacity_bytes=int(40 * PARETO.mean()), sizes=PARETO, max_victims=2)),
    ("arc", {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kw", ABOVE_ONE_BLOCK)
def test_kernel_matches_plain_above_one_block(cuda_device, kind, kw):
    """N above a block's 1024 threads: the strided scan and the cross-warp
    reduction both keep the lowest-id tie-break, and the admission programs'
    block-wide passes (aging, the hot set's top-k) cover every id. Exact on
    hits, freq, in_cache and inserts."""
    n, cap = 5000, 40
    traces = _traces(n, 4, 3000, cuda_device, seed=7)
    program = port_kernel.program_of(kind, kw.get("capacity_bytes", 0))
    before = port_kernel.LAUNCHES[program]
    got = port_kernel.cache_sim_cuda(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    assert port_kernel.LAUNCHES[program] == before + 1
    want = port_kernel.cache_sim_plain(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    assert set(got) - {"argmins"} == set(want)
    _assert_equal([got[k] for k in want], list(want.values()))


@pytest.mark.cuda
def test_byte_mode_kernel_evicts_several_victims_for_one_insert(cuda_device):
    """Under the budget above some insertion needs two or more victims: with
    max_victims=1 the kernel abandons it and the run differs, and both runs
    equal the plain version."""
    n, cap = 5000, 40
    traces = _traces(n, 4, 3000, cuda_device, seed=7)
    kw = dict(kind="lfu", n_objects=n, capacity=cap, **BUDGET)
    runs = []
    for max_victims in (1, 0):
        got = port_kernel.cache_sim_cuda(traces, max_victims=max_victims, **kw)
        want = port_kernel.cache_sim_plain(traces, max_victims=max_victims, **kw)
        assert set(got) == set(want)
        _assert_equal([got[k] for k in want], list(want.values()))
        runs.append(got)
    assert any(not torch.equal(runs[0][k], runs[1][k]) for k in runs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kw", [("arc", {}), ("gdsf", BUDGET), ("tinylfu", {})])
def test_ops_outputs_have_the_same_keys_on_card_and_cpu(cuda_device, kind, kw):
    """``ops.cache_sim_outputs`` is one contract: the kernel's own
    diagnostics (arc's search count) stay out of it."""
    traces = _traces(5000, 2, 800, cuda_device)
    kw = dict(kind=kind, n_objects=5000, capacity=40, **kw)
    card = ops.cache_sim_outputs(traces, **kw)
    cpu = ops.cache_sim_outputs(traces.cpu(), device="cpu", **kw)
    assert set(card) == set(cpu)
    for k in cpu:
        assert torch.equal(card[k].cpu(), cpu[k]), k


@pytest.mark.cuda
def test_kernel_raises_on_out_of_range_ids(cuda_device):
    traces = torch.zeros((2, 16), dtype=torch.int32, device=cuda_device)
    traces[1, 3] = 32
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        port_kernel.cache_sim_cuda(traces, kind="lfu", n_objects=32, capacity=4)


@pytest.mark.cuda
def test_run_grid_on_card_matches_cpu(cuda_device):
    cases = zipf.paper_grid([100, 1000], [0.02, 0.25])
    sized, budget = dict(sizing="sized"), dict(sizing="budget")
    for kind, kw in (("lru", {}), ("plfua", {}), ("wlfu", {}), ("tinylfu", {}), ("plfua_dyn", {}), ("arc", {}),
                     ("gdsf", sized), ("gdsf", budget), ("plfua_dyn", budget)):
        card = simulate.run_grid(kind, cases, n_samples=2, trace_len=2000, **kw)
        cpu = simulate.run_grid(kind, cases, n_samples=2, trace_len=2000, device="cpu", **kw)
        for a, b in zip(card, cpu):
            assert (a.mean_chr, a.std_chr, a.mean_evictions, a.mean_metadata, a.mean_byte_chr) == (
                b.mean_chr, b.std_chr, b.mean_evictions, b.mean_metadata, b.mean_byte_chr)
            assert a.device_s > 0 and a.j_per_request > 0


@pytest.mark.cuda
def test_measure_times_the_kernel(cuda_device):
    traces = _traces(1000, 2, 5000, cuda_device)
    tm = timing.measure(port_kernel.cache_sim_cuda, traces, steps=traces.numel(), repeats=2,
                        kind="lfu", n_objects=1000, capacity=20)
    assert tm.repeats == 2 and 0 < tm.execute_s <= tm.mean_execute_s
    assert tm.power_w > 0 and tm.j_per_step > 0 and tm.card
