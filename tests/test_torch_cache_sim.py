"""The port's cache_sim entry point against the reference kernel.

On the CPU ``ops.cache_sim(..., device="cpu")`` runs the plain PyTorch version;
it must equal the reference Pallas kernel in interpret mode exactly (hits,
freq/stamps, in_cache: all integers), for all nine kinds, tinylfu's
doorkeeper, plfua_dyn's refresh boundary and arc's stamps included (byte mode
is in tests/test_torch_bytes.py). On the card the ``cuda``-marked test
holds the CUDA kernel to the plain version and to the reference on the same
rows; it skips elsewhere, deciding inside a fixture. tests/test_torch_cuda.py
has the card's other tests.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_cache
from repro.core import zipf as ref_zipf
from repro.kernels.cache_sim import cache_sim as ref_cache_sim
from repro.kernels.cache_sim import ops as ref_ops
from repro_torch.kernels.cache_sim import cache_sim as port_kernel
from repro_torch.kernels.cache_sim import ops

# the rows of tests/test_kernels_cache_sim.py's SWEEP (cap == N, cap = 1, N
# crossing a 128-lane pad, the sketch kinds' defaults) plus edge rows
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
    ("wlfu", 64, 9, 3, 400, dict(window=48)),
    ("wlfu", 130, 3, 2, 500, dict(window=33)),
    ("tinylfu", 64, 9, 3, 400, dict(window=48, sketch_width=64)),
    ("tinylfu", 300, 20, 2, 500, dict(window=77, sketch_width=100)),
    ("tinylfu", 64, 9, 2, 400, {}),
    ("plfua_dyn", 64, 9, 3, 400, dict(refresh=97, sketch_width=64)),
    ("plfua_dyn", 130, 3, 2, 500, dict(refresh=50, sketch_width=96, hot_size=7)),
    ("plfua_dyn", 16, 1, 2, 300, dict(refresh=30, sketch_width=64)),
    # tests/test_kernels_cache_sim.py's doorkeeper case, on its traces' shape
    ("tinylfu", 64, 9, 2, 500, dict(window=60, sketch_width=64, doorkeeper=128)),
    # a custom hot set larger than the default, with refreshes
    ("plfua_dyn", 64, 5, 2, 400, dict(refresh=45, sketch_width=64, hot_size=30)),
    # gdsf (unit sizes) and arc (stamps in freq, ghosts included)
    ("gdsf", 64, 9, 3, 400, {}),
    ("gdsf", 130, 3, 2, 500, {}),
    ("arc", 64, 9, 3, 400, {}),
    ("arc", 130, 3, 2, 500, {}),
    ("arc", 16, 1, 2, 300, {}),
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


@pytest.mark.parametrize("trace_len", [388, 400])  # 388 = 4 * 97: exact periods
def test_plfua_dyn_refresh_boundary_matches_reference_kernel(trace_len):
    """A partial tail period must not refresh; an exact multiple refreshes on
    the last step (tests/test_kernels_cache_sim.py's boundary case)."""
    n, cap, kw = 64, 9, dict(refresh=97, sketch_width=64)
    traces = np.stack([ref_zipf.sample_trace(n, trace_len, seed=40 + i) for i in range(2)]).astype(np.int32)
    ref = ref_ops.cache_sim(traces, kind="plfua_dyn", n_objects=n, capacity=cap, interpret=True, **kw)
    port = ops.cache_sim(traces, kind="plfua_dyn", n_objects=n, capacity=cap, device="cpu", **kw)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_doorkeeper_changes_decisions():
    """The doorkeeper'd run really differs from the plain tinylfu run."""
    traces = np.stack([ref_zipf.sample_trace(64, 500, seed=5 + i) for i in range(2)]).astype(np.int32)
    kw = dict(kind="tinylfu", n_objects=64, capacity=9, window=60, sketch_width=64, device="cpu")
    with_dk = ops.cache_sim(traces, doorkeeper=128, **kw)
    without = ops.cache_sim(traces, **kw)
    assert not torch.equal(with_dk[0], without[0])


def test_inserts_match_the_reference_simulator():
    """``cache_sim_outputs``'s ``inserts`` is ``jax_cache``'s
    ``state["inserts"]`` for the sketch kinds and byte mode, and the derived
    count for the others."""
    n, cap = 64, 9
    traces = _traces(n, 2, 400)
    for kind, kw in (("lfu", {}), ("plfua", {}), ("wlfu", dict(window=20)),
                     ("tinylfu", dict(window=50, sketch_width=64, doorkeeper=64)),
                     ("plfua_dyn", dict(refresh=60, sketch_width=64)), ("gdsf", {}), ("arc", {}),
                     ("lfu", dict(capacity_bytes=5)), ("plfua_dyn", dict(refresh=60, capacity_bytes=7))):
        inserts = ops.cache_sim_outputs(traces, kind=kind, n_objects=n, capacity=cap, device="cpu",
                                        **kw)["inserts"]
        spec = jax_cache.PolicySpec(kind=kind, n_objects=n, capacity=cap, **kw)
        for i in range(2):
            hits, state = jax_cache.simulate(spec, jnp.asarray(traces[i]))
            state = {k: np.asarray(v) for k, v in state.items()}
            want = jax_cache.eviction_count(spec, hits, traces[i], state) + int(state["count"])
            assert int(inserts[i]) == want, kind


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
        # telemetry raises; byte budgets, gdsf and arc run as the reference
        # kernel, and a kind that is not size-aware ignores a sizes row
        ("wlfu", dict(window=8, sizes=np.ones(32, np.int32))),
        ("tinylfu", dict(telemetry_window=8)),
        ("plfua_dyn", dict(capacity_bytes=64)),
        ("gdsf", {}),
        ("arc", {}),
        ("lfu", dict(capacity_bytes=64)),
        ("lru", dict(sizes=np.ones(32, np.int32))),
        ("plfu", dict(telemetry_window=8)),
        ("plfua", dict(telemetry_window=8, n_groups=2, groups=np.zeros(32, np.int32))),
    ],
)
def test_unported_kinds_and_options_raise(kind, kw):
    traces = _traces(32, 2, 120, seed=3)
    if "telemetry_window" in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ops.cache_sim(traces, kind=kind, n_objects=32, capacity=4, device="cpu", **kw)
        return
    ref = ref_ops.cache_sim(traces, kind=kind, n_objects=32, capacity=4, interpret=True, **kw)
    port = ops.cache_sim(traces, kind=kind, n_objects=32, capacity=4, device="cpu", **kw)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(kind="nope"), "not in"),
        (dict(kind="lfu", doorkeeper=64), "doorkeeper"),
        (dict(kind="lfu", doorkeeper=-1), "doorkeeper"),
        (dict(kind="lfu", max_victims=2), "max_victims"),
        (dict(kind="lfu", capacity_bytes=-1), "capacity_bytes"),
        (dict(kind="lfu", telemetry_window=-1), "telemetry_window"),
        (dict(kind="wlfu"), "window"),
        (dict(kind="plfua_dyn", doorkeeper=64), "doorkeeper"),
        (dict(kind="tinylfu", sketch_width=-1), "sketch_width"),
        (dict(kind="plfua_dyn", refresh=-1), "refresh"),
        # the reference kernel runs no byte budget for wlfu, tinylfu and arc
        (dict(kind="wlfu", window=8, capacity_bytes=64), "byte-capacity mode is not supported"),
        (dict(kind="tinylfu", capacity_bytes=64), "byte-capacity mode is not supported"),
        (dict(kind="arc", capacity_bytes=64), "byte-capacity mode is not supported"),
        (dict(kind="gdsf", sizes=np.ones(31, np.int32)), r"sizes must have shape \(32,\)"),
        (dict(kind="lfu", capacity_bytes=64, sizes=np.ones((2, 32), np.int32)), "sizes must have shape"),
        (dict(kind="gdsf", sizes=np.zeros(32, np.int32)), "sizes must be >= 1"),
        (dict(kind="lfu", capacity_bytes=64, max_victims=-1), "max_victims"),
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
    before = dict(port_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_kernel.cache_sim_cuda(traces, kind="lfu", n_objects=32, capacity=4)
    assert port_kernel.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,cap,s,t,kw", SWEEP)
def test_kernel_matches_plain_on_card(cuda_device, kind, n, cap, s, t, kw):
    traces_np = _traces(n, s, t)
    traces = torch.as_tensor(traces_np, device=cuda_device)
    program = port_kernel.PROGRAM_OF[kind]
    before = port_kernel.LAUNCHES[program]
    got = ops.cache_sim(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    torch.cuda.synchronize()
    assert port_kernel.LAUNCHES[program] == before + 1
    want = port_kernel.cache_sim_plain(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    want = [want[k] for k in ("hits", "freq", "in_cache")]
    ref = ref_ops.cache_sim(traces_np, kind=kind, n_objects=n, capacity=cap, interpret=True, **kw)
    for a, b, r in zip(got, want, ref):
        assert a.is_cuda and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(r))


@pytest.mark.parametrize("program", sorted(port_kernel.PROGRAMS))
def test_program_entry_matches_its_c_signature(program):
    """Each program's ctypes argument types follow its C entry point's
    parameters (a pointer as ``c_void_p``, an int as ``c_int``): a mismatch
    would pass a pointer cut to 32 bits, and no CPU run could show it."""
    prog = port_kernel.PROGRAMS[program]
    source = prog.source.read_text()
    match = re.search(r'extern "C" int ' + prog.entry + r"\(([^)]*)\)", source)
    assert match, f"{prog.entry} not found in {prog.source.name}"
    params = [p.strip() for p in match.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.startswith("int ") for p in params), params
    assert list(prog.argtypes) == want
    programs = set(port_kernel.PROGRAM_OF.values()) | set(port_kernel.BYTES_PROGRAM_OF.values())
    assert programs == set(port_kernel.PROGRAMS)
    assert set(port_kernel.PROGRAM_OF) == set(port_kernel.KERNEL_KINDS)
    assert set(port_kernel.BYTES_PROGRAM_OF) == set(ref_cache_sim.BYTE_CAPABLE_KINDS)
