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
from repro_torch.core import torch_cache
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
    # the heap programs' edges: capacity <= 0 (one resident; the first victim is id 0, not
    # cached: lfu zeroes its count, gdsf's credit takes its score), ties among equal keys on a
    # cyclic trace (each id equally often), and gdsf holding every id
    ("lfu", 64, 0, 3, 400, {}),
    ("lfu", 64, -3, 3, 400, {}),
    ("lru", 64, 0, 3, 400, {}),
    ("lru", 64, -3, 3, 400, {}),
    ("gdsf", 64, 0, 3, 400, {}),
    ("gdsf", 64, -3, 3, 400, {}),
    ("lfu", 40, 7, 2, 400, dict(trace="cyclic")),
    ("plfu", 40, 7, 2, 400, dict(trace="cyclic")),
    ("gdsf", 64, 64, 2, 300, {}),
    # the scan programs at capacity <= 0: the first victim is id 0, not cached (arc's empty
    # list names it too, wherever id 0 sits), and the cache then holds one resident
    ("arc", 64, 0, 3, 400, {}),
    ("arc", 64, -3, 3, 400, {}),
    ("tinylfu", 64, 0, 3, 400, dict(window=48, sketch_width=64)),
    ("tinylfu", 64, -3, 3, 400, dict(window=48, sketch_width=64)),
    ("tinylfu", 64, 0, 2, 500, dict(window=60, sketch_width=64, doorkeeper=128)),
    ("tinylfu", 64, -3, 2, 500, dict(window=60, sketch_width=64, doorkeeper=128)),
    ("wlfu", 64, 0, 3, 400, dict(window=48)),
    ("wlfu", 64, -3, 3, 400, dict(window=48)),
    ("plfua_dyn", 64, 0, 3, 400, dict(refresh=97, sketch_width=64)),
    ("plfua_dyn", 64, -3, 3, 400, dict(refresh=97, sketch_width=64)),
]


@pytest.fixture
def cuda_device():
    """The card, decided when a test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _traces(n, s, t, seed=100, trace="zipf"):
    """Zipf traces, or (``trace="cyclic"``) ids 0..n-1 in turn, shifted a step a sample."""
    if trace == "cyclic":
        return np.stack([(np.arange(t) + i) % n for i in range(s)]).astype(np.int32)
    return np.stack([ref_zipf.sample_trace(n, t, seed=seed + i) for i in range(s)]).astype(np.int32)


@pytest.mark.parametrize("kind,n,cap,s,t,kw", SWEEP)
def test_port_matches_reference_kernel(kind, n, cap, s, t, kw):
    kw = dict(kw)
    traces = _traces(n, s, t, trace=kw.pop("trace", "zipf"))
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
        # telemetry (grouped too), byte budgets, gdsf and arc run as the
        # reference kernel, and a kind that is not size-aware ignores a sizes row
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
    ref = ref_ops.cache_sim(traces, kind=kind, n_objects=32, capacity=4, interpret=True, **kw)
    port = ops.cache_sim(traces, kind=kind, n_objects=32, capacity=4, device="cpu", **kw)
    assert len(port) == len(ref) == (4 if "telemetry_window" in kw else 3)
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


@pytest.mark.parametrize("kind,n,cap,kw,size_range,slots", [
    ("lfu", 100, 25, {}, None, 25),
    ("lru", 64, 0, {}, None, 1),  # capacity <= 0 holds one resident
    ("lfu", 64, -3, {}, None, 1),
    ("plfua", 64, 200, {}, None, 64),  # never more than N
    ("gdsf", 5000, 40, {}, None, 5000),  # a wrapped score can reach INT_MAX: N
    ("lru", 5000, 40, dict(capacity_bytes=900), (3, 40), 300),
    ("lfu", 5000, 40, dict(capacity_bytes=2), (3, 40), 0),  # nothing fits
    ("lfu", 5000, 40, dict(capacity_bytes=2**31 - 10), (1, 20), 5000),  # cap_bytes + size can wrap
    ("gdsf", 5000, 40, dict(capacity_bytes=900), (3, 40), 5000),
    # tinylfu inserts past its count only into an empty heap (capacity <= 0), once
    ("tinylfu", 100, 25, {}, None, 25),
    ("tinylfu", 64, 0, {}, None, 1),
    ("tinylfu", 64, -3, dict(doorkeeper=128), None, 1),
    ("tinylfu", 64, 200, {}, None, 64),
    # wlfu's window counts and plfua_dyn's counts stay below INT_MAX, as lfu's do
    ("wlfu", 100, 25, dict(window=10), None, 25),
    ("wlfu", 64, 0, dict(window=10), None, 1),
    ("wlfu", 64, -3, dict(window=1), None, 1),
    ("wlfu", 64, 200, dict(window=500), None, 64),
    ("plfua_dyn", 100, 25, {}, None, 25),
    ("plfua_dyn", 64, 0, dict(hot_size=7), None, 1),
    ("plfua_dyn", 64, -3, {}, None, 1),
    ("plfua_dyn", 64, 200, dict(refresh=50), None, 64),
    ("plfua_dyn", 5000, 40, dict(capacity_bytes=900), (3, 40), 300),
    ("plfua_dyn", 5000, 40, dict(capacity_bytes=2), (3, 40), 0),
    ("plfua_dyn", 5000, 40, dict(capacity_bytes=2**31 - 10), (1, 20), 5000),
])
def test_heap_plan_bounds_the_cached_ids(kind, n, cap, kw, size_range, slots):
    """The heap's slots are the most ids the cache can hold, and the plan never asks for more
    shared memory than a block has (plfua_dyn's block keeps 32 bytes of static shared memory
    for its sums)."""
    plan = port_kernel.heap_plan(port_kernel.spec_of(kind, n, cap, **kw), size_range)
    static = port_kernel._REDUCE_BYTES if kind == "plfua_dyn" else 0
    assert plan.slots == slots and plan.shared_bytes + static <= port_kernel.SHARED_BYTES
    assert plan.can_move == (plan.shared_slots < plan.slots)
    assert bool(plan.hot_bytes) == (kind == "plfua_dyn")
    assert bool(plan.sketch_bytes) == (kind in ("tinylfu", "plfua_dyn"))


@pytest.mark.parametrize("kind,kw", [("wlfu", dict(window=7)), ("wlfu", dict(window=1)),
                                     ("plfua_dyn", dict(refresh=40, sketch_width=64, hot_size=7)),
                                     ("plfua_dyn", dict(refresh=40, sketch_width=64, hot_size=30))])
@pytest.mark.parametrize("cap", [-3, 0, 1, 5])
def test_never_caches_more_ids_than_its_heap_slots(kind, kw, cap):
    """wlfu's and plfua_dyn's bound, step by step on the plain version: a Zipf and a cyclic
    trace never leave more cached ids than the plan's slots, and reach them."""
    n, t = 30, 400
    traces = torch.as_tensor(np.concatenate([_traces(n, 2, t), _traces(n, 2, t, trace="cyclic")]))
    spec = port_kernel.spec_of(kind, n, cap, **kw)
    slots = port_kernel.heap_plan(spec).slots
    state = torch_cache.init_state(spec, n_samples=traces.shape[0], device="cpu")
    most = 0
    for i in range(t):
        state, _ = torch_cache.step(spec, state, traces[:, i])
        if kind == "plfua_dyn" and (i + 1) % spec.effective_refresh == 0:
            torch_cache.refresh_hot(spec, state)
        most = max(most, int(state["in_cache"].sum(dim=1).max()))
    assert most == slots


@pytest.mark.parametrize("cap", [-3, 0, 1, 5])
@pytest.mark.parametrize("kw", [dict(window=40, sketch_width=64), dict(window=40, sketch_width=64, doorkeeper=128)])
def test_tinylfu_never_caches_more_ids_than_its_heap_slots(cap, kw):
    """The bound heap_plan proves, step by step on the plain version: a Zipf and a cyclic
    trace never leave more cached ids than the plan's slots, and reach them."""
    n, t = 30, 400
    traces = torch.as_tensor(np.concatenate([_traces(n, 2, t), _traces(n, 2, t, trace="cyclic")]))
    spec = port_kernel.spec_of("tinylfu", n, cap, **kw)
    slots = port_kernel.heap_plan(spec).slots
    state = torch_cache.init_state(spec, n_samples=traces.shape[0], device="cpu")
    most = 0
    for i in range(t):
        state, _ = torch_cache.step(spec, state, traces[:, i])
        most = max(most, int(state["in_cache"].sum(dim=1).max()))
    assert most == slots


def test_heap_plan_places_tinylfu_sketch_and_rows_in_order():
    """tinylfu's heap first, then its sketch (4 x width int32 and a byte a doorkeeper bit),
    then its rows (pos, freq), each where it still fits: at the measured case (cap 2,000,
    width 8,000) the sketch joins the heap and the rows cannot; where only one of the two
    fits beside the heap, the sketch does."""
    measured = port_kernel.heap_plan(port_kernel.spec_of("tinylfu", 100_000, 2_000))
    assert (measured.shared_slots, measured.sketch_bytes) == (2_000, 128_000)
    assert measured.sketch_shared and not measured.rows_shared and measured.shared_bytes == 144_000
    # heap 320 B, sketch 4,096 B: the rows (8 B an id) fit up to N = 28,504
    for n, rows in ((28_504, True), (28_505, False)):
        plan = port_kernel.heap_plan(port_kernel.spec_of("tinylfu", n, 40))
        assert (plan.rows_shared, plan.sketch_shared) == (rows, True)
        assert (plan.shared_bytes == port_kernel.SHARED_BYTES) == rows
    # heap 8,000 B: a sketch of width 14,028 fills the rest exactly, one counter more does not
    for width, shared in ((14_028, True), (14_029, False)):
        plan = port_kernel.heap_plan(port_kernel.spec_of("tinylfu", 100_000, 1_000, sketch_width=width))
        assert plan.sketch_shared == shared and not plan.rows_shared
    # N = 20,000, cap 500: heap 4,000 B, sketch 32,000 B, rows 160,000 B; both fit beside the heap
    both = port_kernel.heap_plan(port_kernel.spec_of("tinylfu", 20_000, 500))
    assert both.sketch_shared and both.rows_shared
    # the heap's 25,000 slots (200,000 B) leave room for neither at N = 100,000
    largest = port_kernel.heap_plan(port_kernel.spec_of("tinylfu", 100_000, 25_000))
    assert largest.shared_slots == 25_000 and not largest.sketch_shared and not largest.rows_shared
    # N = 24,000, cap 1,250: heap 10,000 B, sketch 80,000 B, rows 192,000 B: either joins, not both
    plan = port_kernel.heap_plan(port_kernel.spec_of("tinylfu", 24_000, 1_250))
    assert plan.sketch_shared and not plan.rows_shared and plan.shared_bytes == 90_000


@pytest.mark.parametrize("n,shared", [
    (100, True), (25_827, True), (25_828, False),  # 9 B an id, links 8-byte aligned
    (100_000, False), (232_448, False), (232_449, False),
])
def test_arc_plan_places_its_rows_where_they_fit(n, shared):
    """arc's tags (a byte an id) and links (8 B an id, after the tags at an 8-byte boundary)
    lie in shared memory together where both fit, else both in device memory; the plan never
    asks for more than a block has."""
    plan = port_kernel.arc_plan(port_kernel.spec_of("arc", n, 10))
    assert plan.shared == shared
    assert plan.shared_bytes <= port_kernel.SHARED_BYTES
    assert plan.shared_bytes == (-(-n // 8) * 8 + 8 * n if shared else 0)


@pytest.mark.parametrize("kind", ["lru", "lfu", "plfu", "plfua", "gdsf"])
def test_heap_plan_on_the_paper_grid(kind):
    """On the paper's grid no heap outgrows shared memory: the base kinds' rows join it up to
    N = 21,544, gdsf's (N slots) up to N = 10,000."""
    for case in ref_zipf.paper_grid():
        n, cap = case.n_objects, case.cache_size
        plan = port_kernel.heap_plan(port_kernel.spec_of(kind, n, cap), (1, 1))
        assert plan.shared_slots >= (cap if kind != "gdsf" else min(n, port_kernel.SHARED_BYTES // 8))
        assert plan.rows_shared == (n <= (10_000 if kind == "gdsf" else 21_544))


def test_tinylfu_heap_plan_on_the_paper_grid():
    """tinylfu on the paper's grid: every heap lies in shared memory; the sketch (16 B a
    counter, width max(4 cap, 256)) joins it up to cap 3,228 (72 B a slot and its four
    counters), 50 of the 60 cases; the rows join what is left in 45, every case up to N =
    4,642, and at N = 21,544 also where the sketch did not fit."""
    placed = {}
    for case in ref_zipf.paper_grid():
        n, cap = case.n_objects, case.cache_size
        plan = port_kernel.heap_plan(port_kernel.spec_of("tinylfu", n, cap))
        assert plan.shared_slots == plan.slots == cap and plan.shared_bytes <= port_kernel.SHARED_BYTES
        placed[n, cap] = (plan.sketch_shared, plan.rows_shared)
    assert {k for k, (sketch_shared, _) in placed.items() if not sketch_shared} == {
        (21_544, 3_250), (21_544, 5_386), (46_416, 4_225), (46_416, 7_002), (46_416, 11_604),
        (100_000, 3_314), (100_000, 5_493), (100_000, 9_103), (100_000, 15_085), (100_000, 25_000)}
    assert {k for k, (_, rows_shared) in placed.items() if rows_shared} == (
        {k for k in placed if k[0] <= 4_642} | {(10_000, cap) for cap in (200, 331, 549, 910, 1_509)}
        | {(21_544, cap) for cap in (431, 714, 3_250, 5_386)})


def test_wlfu_and_plfua_dyn_heap_plans_on_the_paper_grid():
    """wlfu and plfua_dyn on the paper's grid: every heap lies in shared memory. wlfu's rows
    join it up to N = 21,544, as lfu's. plfua_dyn's sketch joins it where tinylfu's does
    (every case but the 10 of cap >= 3,250 at N >= 21,544); its hot mask (a byte an id) in
    58 cases, all but N = 100,000 at cap 2,000 and 25,000; its rows in 43: every case up to
    N = 4,642, and at N = 10,000 and 21,544 where the heap, sketch and mask leave room."""
    placed = {}
    for case in ref_zipf.paper_grid():
        n, cap = case.n_objects, case.cache_size
        wlfu = port_kernel.heap_plan(port_kernel.spec_of("wlfu", n, cap, window=10_000))
        assert wlfu.shared_slots == wlfu.slots == cap and not (wlfu.sketch_bytes or wlfu.hot_bytes)
        assert wlfu.rows_shared == (n <= 21_544)
        plan = port_kernel.heap_plan(port_kernel.spec_of("plfua_dyn", n, cap))
        assert plan.shared_slots == plan.slots == cap
        assert plan.shared_bytes + port_kernel._REDUCE_BYTES <= port_kernel.SHARED_BYTES
        tinylfu = port_kernel.heap_plan(port_kernel.spec_of("tinylfu", n, cap))
        assert plan.sketch_shared == tinylfu.sketch_shared
        placed[n, cap] = (plan.hot_shared, plan.rows_shared)
    assert {k for k, (hot_shared, _) in placed.items() if not hot_shared} == {(100_000, 2_000), (100_000, 25_000)}
    assert {k for k, (_, rows_shared) in placed.items() if rows_shared} == (
        {k for k in placed if k[0] <= 4_642} | {(10_000, cap) for cap in (200, 331, 549, 910, 1_509)}
        | {(21_544, 431), (21_544, 3_250)})


def test_plfua_dyn_heap_plan_places_sketch_hot_mask_and_rows_in_order():
    """plfua_dyn's heap first, then its sketch (4 x width int32), then its hot mask (a byte an
    id, in whole warps), then its rows (pos, freq), each where it still fits in the 232,416
    bytes its 32 bytes of static shared memory leave: at the measured case (cap 2,000, width
    8,000) heap and sketch take 144,000 B and neither the mask (100,000 B) nor the rows can
    join. A heap that cannot lie there whole (byte mode's N slots) comes after the sketch."""
    budget = port_kernel.SHARED_BYTES - port_kernel._REDUCE_BYTES
    measured = port_kernel.heap_plan(port_kernel.spec_of("plfua_dyn", 100_000, 2_000))
    assert (measured.shared_slots, measured.sketch_bytes, measured.hot_bytes) == (2_000, 128_000, 100_000)
    assert measured.sketch_shared and not measured.hot_shared and not measured.rows_shared
    assert measured.shared_bytes == 144_000
    # a heap of 8,000 B: a sketch of width 14,026 fills the rest; one counter more and the mask joins instead
    for width, shared in ((14_026, True), (14_027, False)):
        plan = port_kernel.heap_plan(port_kernel.spec_of("plfua_dyn", 100_000, 1_000, sketch_width=width))
        assert (plan.sketch_shared, plan.hot_shared) == (shared, not shared)
        assert (plan.shared_bytes == budget) == shared
    # N = 99,968 (a mask of 99,968 B), heap 8,000 B: width 7,778 leaves the mask its room exactly
    for width, shared in ((7_778, True), (7_779, False)):
        plan = port_kernel.heap_plan(port_kernel.spec_of("plfua_dyn", 99_968, 1_000, sketch_width=width))
        assert plan.sketch_shared and plan.hot_shared == shared and not plan.rows_shared
        assert (plan.shared_bytes == budget) == shared
    # heap 320 B, sketch 4,096 B, then mask and rows (9 B an id) fill the budget exactly at N = 25,332
    for n, rows in ((25_332, True), (25_333, False)):
        plan = port_kernel.heap_plan(port_kernel.spec_of("plfua_dyn", n, 40, sketch_width=256))
        assert plan.sketch_shared and plan.hot_shared and plan.rows_shared == rows
        assert plan.hot_bytes == -(-n // 32) * 32
        assert (plan.shared_bytes == budget) == rows
    # under a budget of 263,530 bytes with sizes >= 1 the heap takes N slots: the sketch first, the
    # heap's shared slots what is left (13,052), past which it moves to device memory
    sized = port_kernel.heap_plan(port_kernel.spec_of("plfua_dyn", 100_000, 2_000, capacity_bytes=263_530), (1, 5_000))
    assert (sized.slots, sized.shared_slots) == (100_000, 13_052) and sized.can_move
    assert sized.sketch_shared and not sized.hot_shared and sized.shared_bytes == budget


def test_arc_plan_on_the_paper_grid():
    """The paper's N: the tags and links fit shared memory up to N = 21,544."""
    for case in ref_zipf.paper_grid():
        plan = port_kernel.arc_plan(port_kernel.spec_of("arc", case.n_objects, case.cache_size))
        assert plan.shared == (case.n_objects <= 21_544)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,cap,s,t,kw", SWEEP)
def test_kernel_matches_plain_on_card(cuda_device, kind, n, cap, s, t, kw):
    kw = dict(kw)
    traces_np = _traces(n, s, t, trace=kw.pop("trace", "zipf"))
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


@pytest.mark.parametrize("kind,kw", [
    ("gdsf", {}),
    ("lru", dict(capacity_bytes=64)),
    ("plfua_dyn", dict(capacity_bytes=64)),
    ("plfua_dyn", {}),
    ("tinylfu", dict(doorkeeper=64)),
    ("arc", {}),
    ("wlfu", dict(window=8)),
    ("lfu", {}),
])
@pytest.mark.parametrize("n_groups", [0, 3])
@pytest.mark.parametrize("shared_bytes", [port_kernel.SHARED_BYTES, 64])
def test_launch_arguments_point_only_into_tensors_the_wrapper_holds(monkeypatch, kind, kw, n_groups, shared_bytes):
    """Every pointer the C entry receives, besides the traces, belongs to a
    tensor in the outputs (scratch under ``_`` names), so none is freed before
    the launch is queued; with 64 bytes of shared memory the rows, heap,
    sketch and hot mask take device scratch. A unit-size row made for the
    call and dropped at once handed the kernel freed memory."""
    monkeypatch.setattr(port_kernel, "SHARED_BYTES", shared_bytes)
    traces = torch.zeros((2, 16), dtype=torch.int32)
    spec = port_kernel.spec_of(kind, 32, 4, **kw)
    telemetry, groups = port_kernel.telemetry_options(32, 4, n_groups, np.zeros(32, np.int32) if n_groups else None)
    sizes, size_range = port_kernel._sizes_row(spec, None, "cpu")
    program, outs, args = port_kernel._launch_args(spec, traces, sizes, telemetry, groups, size_range)
    held = {v.data_ptr() for v in outs.values() if isinstance(v, torch.Tensor)}
    prog = port_kernel.PROGRAMS[program]
    pointers = [a for a, t in zip(args, prog.argtypes) if t is ctypes.c_void_p]
    assert pointers[0] == traces.data_ptr()
    assert all(p in held for p in pointers[1:] if p), (program, pointers, held)
    assert ("series" in outs) == bool(telemetry)
