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


# options that make the ring wrap, the sketch age and the hot set refresh
# several times within the 3,000-request traces below
ABOVE_ONE_BLOCK = [
    ("lru", {}), ("lfu", {}), ("plfu", {}), ("plfua", {}),
    ("wlfu", dict(window=500)),
    ("tinylfu", dict(window=400)),
    ("tinylfu", dict(window=400, doorkeeper=320)),
    ("plfua_dyn", dict(refresh=700)),
    ("plfua_dyn", dict(refresh=500, hot_size=4_000, sketch_width=300)),
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
    program = port_kernel.PROGRAM_OF[kind]
    before = port_kernel.LAUNCHES[program]
    got = port_kernel.cache_sim_cuda(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    assert port_kernel.LAUNCHES[program] == before + 1
    _assert_equal(got, port_kernel.cache_sim_plain(traces, kind=kind, n_objects=n, capacity=cap, **kw))


@pytest.mark.cuda
def test_kernel_raises_on_out_of_range_ids(cuda_device):
    traces = torch.zeros((2, 16), dtype=torch.int32, device=cuda_device)
    traces[1, 3] = 32
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        port_kernel.cache_sim_cuda(traces, kind="lfu", n_objects=32, capacity=4)


@pytest.mark.cuda
def test_run_grid_on_card_matches_cpu(cuda_device):
    cases = zipf.paper_grid([100, 1000], [0.02, 0.25])
    for kind in ("lru", "plfua", "wlfu", "tinylfu", "plfua_dyn"):
        card = simulate.run_grid(kind, cases, n_samples=2, trace_len=2000)
        cpu = simulate.run_grid(kind, cases, n_samples=2, trace_len=2000, device="cpu")
        for a, b in zip(card, cpu):
            assert (a.mean_chr, a.std_chr, a.mean_evictions, a.mean_metadata) == (
                b.mean_chr, b.std_chr, b.mean_evictions, b.mean_metadata)
            assert a.device_s > 0 and a.j_per_request > 0


@pytest.mark.cuda
def test_measure_times_the_kernel(cuda_device):
    traces = _traces(1000, 2, 5000, cuda_device)
    tm = timing.measure(port_kernel.cache_sim_cuda, traces, steps=traces.numel(), repeats=2,
                        kind="lfu", n_objects=1000, capacity=20)
    assert tm.repeats == 2 and 0 < tm.execute_s <= tm.mean_execute_s
    assert tm.power_w > 0 and tm.j_per_step > 0 and tm.card
