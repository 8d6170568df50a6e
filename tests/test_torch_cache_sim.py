"""The port's cache_sim entry point against the reference kernel.

On the CPU ``ops.cache_sim(..., device="cpu")`` runs the plain PyTorch version;
it must equal the reference Pallas kernel in interpret mode exactly (hits,
freq/stamps, in_cache: all integers). On the card the ``cuda``-marked test
holds the CUDA kernel to the plain version and to the reference on the same
rows; it skips elsewhere, deciding inside a fixture. tests/test_torch_cuda.py
has the card's other tests.
"""
import numpy as np
import pytest
import torch

from repro.core import zipf as ref_zipf
from repro.kernels.cache_sim import ops as ref_ops
from repro_torch.kernels.cache_sim import cache_sim as port_kernel
from repro_torch.kernels.cache_sim import ops

# the lru/lfu/plfu/plfua rows of tests/test_kernels_cache_sim.py's SWEEP
# (cap == N, cap = 1, N crossing a 128-lane pad) plus lru/plfua edge rows
SWEEP = [
    # (kind, n_objects, capacity, n_samples, trace_len, kwargs)
    ("lfu", 64, 9, 3, 400, {}),
    ("lfu", 200, 50, 2, 600, {}),
    ("plfu", 64, 9, 3, 400, {}),
    ("plfu", 130, 3, 2, 500, {}),
    ("plfua", 64, 9, 3, 400, {}),
    ("plfua", 300, 20, 2, 500, {}),
    ("lru", 64, 9, 3, 400, {}),
    ("lru", 100, 25, 2, 500, {}),
    ("lfu", 128, 128, 2, 300, {}),
    ("plfu", 16, 1, 2, 300, {}),
    ("lru", 16, 1, 2, 300, {}),
    ("plfua", 50, 5, 1, 400, dict(hot_size=7)),
]


@pytest.fixture
def cuda_device():
    """The card, decided when a test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _traces(n, s, t, seed=100):
    return np.stack([ref_zipf.sample_trace(n, t, seed=seed + i) for i in range(s)]).astype(np.int32)


@pytest.mark.parametrize("kind,n,cap,s,t,kw", SWEEP)
def test_port_matches_reference_kernel(kind, n, cap, s, t, kw):
    traces = _traces(n, s, t)
    hits_r, freq_r, cache_r = ref_ops.cache_sim(
        traces, kind=kind, n_objects=n, capacity=cap, interpret=True, **kw
    )
    hits, freq, in_cache = ops.cache_sim(traces, kind=kind, n_objects=n, capacity=cap, device="cpu", **kw)
    assert hits.dtype == torch.int32 and freq.dtype == torch.int32 and in_cache.dtype == torch.bool
    np.testing.assert_array_equal(hits.numpy(), np.asarray(hits_r))
    np.testing.assert_array_equal(freq.numpy(), np.asarray(freq_r))
    np.testing.assert_array_equal(in_cache.numpy(), np.asarray(cache_r))


def test_uniform_trace_matches_reference_kernel():
    rng = np.random.default_rng(0)
    traces = rng.integers(0, 77, size=(2, 321)).astype(np.int32)
    for kind in ("lfu", "plfu", "plfua", "lru"):
        ref = ref_ops.cache_sim(traces, kind=kind, n_objects=77, capacity=13, interpret=True)
        port = ops.cache_sim(traces, kind=kind, n_objects=77, capacity=13, device="cpu")
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize(
    "kind,kw",
    [
        ("wlfu", dict(window=8)),
        ("tinylfu", {}),
        ("plfua_dyn", {}),
        ("gdsf", {}),
        ("arc", {}),
        ("lfu", dict(capacity_bytes=64)),
        ("lru", dict(sizes=np.ones(32, np.int32))),
        ("plfu", dict(telemetry_window=8)),
        ("plfua", dict(telemetry_window=8, n_groups=2, groups=np.zeros(32, np.int32))),
    ],
)
def test_unported_kinds_and_options_raise(kind, kw):
    traces = np.zeros((1, 16), np.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.cache_sim(traces, kind=kind, n_objects=32, capacity=4, device="cpu", **kw)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(kind="nope"), "not in"),
        (dict(kind="lfu", doorkeeper=64), "doorkeeper"),
        (dict(kind="lfu", doorkeeper=-1), "doorkeeper"),
        (dict(kind="lfu", max_victims=2), "max_victims"),
        (dict(kind="lfu", capacity_bytes=-1), "capacity_bytes"),
        (dict(kind="lfu", telemetry_window=-1), "telemetry_window"),
    ],
)
def test_bad_options_raise_value_error(kw, match):
    traces = np.zeros((1, 16), np.int32)
    with pytest.raises(ValueError, match=match):
        ops.cache_sim(traces, n_objects=32, capacity=4, device="cpu", **kw)


@pytest.mark.parametrize("bad_id", [-1, 32])
def test_out_of_range_ids_raise(bad_id):
    traces = np.zeros((2, 16), np.int32)
    traces[1, 7] = bad_id
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        ops.cache_sim(traces, kind="lfu", n_objects=32, capacity=4, device="cpu")


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    traces = np.zeros((1, 16), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.cache_sim(traces, kind="lfu", n_objects=32, capacity=4)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No quiet fallback: the CUDA wrapper takes CUDA tensors only."""
    traces = torch.zeros((1, 16), dtype=torch.int32)
    before = port_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_kernel.cache_sim_cuda(traces, kind="lfu", n_objects=32, capacity=4)
    assert port_kernel.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,cap,s,t,kw", SWEEP)
def test_kernel_matches_plain_on_card(cuda_device, kind, n, cap, s, t, kw):
    traces_np = _traces(n, s, t)
    traces = torch.as_tensor(traces_np, device=cuda_device)
    before = port_kernel.LAUNCHES
    got = ops.cache_sim(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    torch.cuda.synchronize()
    assert port_kernel.LAUNCHES == before + 1
    want = port_kernel.cache_sim_plain(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    ref = ref_ops.cache_sim(traces_np, kind=kind, n_objects=n, capacity=cap, interpret=True, **kw)
    for a, b, r in zip(got, want, ref):
        assert a.is_cuda and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(r))
