"""The CUDA kernels, the grid harness and the engine on the card, against the plain versions.

Every test here is marked ``cuda`` and skips where there is no card; the check
happens in a fixture when a test runs, never while the module is imported. The
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``tests/test_torch_cache_sim.py`` holds the cache_sim kernel to the plain
version and to the JAX reference on the small shapes. Everything cache_sim
compares is an integer, so the tolerance is exact; the flash kernel's
tolerances are stated at its tests below.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import simulate, zipf
from repro_torch.kernels.cache_sim import cache_sim as port_kernel
from repro_torch.kernels.cache_sim import ops
from repro_torch.telemetry import spec as telemetry_spec
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
    """N above a block's threads: the heap keeps the lowest-id tie-break, and
    the warp's and block's passes (tinylfu's aging, plfua_dyn's top-k over
    its 256 threads) cover every id. Exact on hits, freq, in_cache and
    inserts."""
    n, cap = 5000, 40
    traces = _traces(n, 4, 3000, cuda_device, seed=7)
    program = port_kernel.program_of(kind, kw.get("capacity_bytes", 0))
    before = port_kernel.LAUNCHES[program]
    got = port_kernel.cache_sim_cuda(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    assert port_kernel.LAUNCHES[program] == before + 1
    want = port_kernel.cache_sim_plain(traces, kind=kind, n_objects=n, capacity=cap, **kw)
    assert set(got) - {"argmins"} == set(want)
    _assert_equal([got[k] for k in want], list(want.values()))


# one case per program (and byte mode's multi-victim bound), above one block
TELEMETRY_CASES = [
    ("lfu", {}), ("plfua", {}), ("wlfu", dict(window=500)),
    ("tinylfu", dict(window=400, doorkeeper=320)),
    ("plfua_dyn", dict(refresh=700)), ("gdsf", dict(sizes=LOGNORMAL)), ("lru", BUDGET),
    ("gdsf", dict(capacity_bytes=int(40 * PARETO.mean()), sizes=PARETO, max_victims=2)),
    ("plfua_dyn", dict(refresh=700, **BUDGET)), ("arc", {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_groups", [0, 4])
@pytest.mark.parametrize("kind,kw", TELEMETRY_CASES)
def test_kernel_series_matches_plain(cuda_device, kind, kw, n_groups):
    """Each program's telemetry instance, ungrouped and per tenant group on
    multi_tenant traces: the series equals the plain version's exactly
    (3,000 requests, W = 230: a partial last window), its primary outputs
    equal the instance without telemetry's, and only the telemetry
    instance's launch count moves."""
    n, cap, w = 5000, 40, 230
    traces = torch.as_tensor(generators.multi_tenant(n, 4, 3000, seed=7), device=cuda_device)
    tel = dict(telemetry_window=w, n_groups=n_groups,
               groups=generators.tenant_groups(n, 4) if n_groups else None)
    call = dict(kind=kind, n_objects=n, capacity=cap, **kw)
    instance = port_kernel.instance_of(port_kernel.program_of(kind, kw.get("capacity_bytes", 0)), w, n_groups)
    before = dict(port_kernel.LAUNCHES)
    got = port_kernel.cache_sim_cuda(traces, **call, **tel)
    assert port_kernel.LAUNCHES == {**before, instance: before[instance] + 1}
    want = port_kernel.cache_sim_plain(traces, **call, **tel)
    assert set(got) - {"argmins"} == set(want) and "series" in want
    _assert_equal([got[k] for k in want], list(want.values()))
    off = port_kernel.cache_sim_cuda(traces, **call)
    for k in off:
        assert torch.equal(off[k], got[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 701])
def test_kernel_series_window_edges(cuda_device, w):
    """W = 1 (a window a request, occupancy after each) and W > T (one
    partial window) for every program, grouped, at 700 requests."""
    n, cap = 300, 6
    traces = torch.as_tensor(generators.multi_tenant(n, 3, 700, seed=2, n_tenants=3), device=cuda_device)
    groups = generators.tenant_groups(n, 3)
    sizes = generators.object_sizes(n, dist="pareto", corr=0.5, seed=11, median=16)
    budget = dict(sizes=sizes, capacity_bytes=int(cap * sizes.mean()))
    for kind, kw in (("lru", {}), ("wlfu", dict(window=50)), ("tinylfu", dict(window=60)),
                     ("plfua_dyn", dict(refresh=97)), ("gdsf", budget), ("plfua_dyn", dict(refresh=97, **budget)),
                     ("arc", {})):
        call = dict(kind=kind, n_objects=n, capacity=cap, telemetry_window=w, n_groups=3, groups=groups, **kw)
        got = port_kernel.cache_sim_cuda(traces, **call)
        want = port_kernel.cache_sim_plain(traces, **call)
        _assert_equal([got[k] for k in want], list(want.values()))


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [0, -3])
@pytest.mark.parametrize("kind,kw", [("wlfu", dict(window=50)), ("tinylfu", dict(window=60)),
                                     ("tinylfu", dict(window=60, doorkeeper=64)), ("plfua_dyn", dict(refresh=97)),
                                     ("plfua_dyn", dict(refresh=97, hot_size=7)), ("arc", {})])
def test_kernel_series_at_capacity_at_most_zero(cuda_device, kind, kw, capacity):
    """At capacity <= 0 the first victim is id 0 while it is not cached: it counts in no
    group (and for arc, whose cache counts its residents, in neither series). Each program's
    ungrouped and grouped series equal the plain version's."""
    n = 300
    traces = torch.as_tensor(generators.multi_tenant(n, 3, 700, seed=2, n_tenants=3), device=cuda_device)
    groups = generators.tenant_groups(n, 3)
    for n_groups in (0, 3):
        call = dict(kind=kind, n_objects=n, capacity=capacity, telemetry_window=230, n_groups=n_groups,
                    groups=groups if n_groups else None, **kw)
        got = port_kernel.cache_sim_cuda(traces, **call)
        want = port_kernel.cache_sim_plain(traces, **call)
        _assert_equal([got[k] for k in want], list(want.values()))


@pytest.mark.cuda
def test_ops_telemetry_runs_the_kernel_on_the_card(cuda_device):
    """``ops.cache_sim`` with a CUDA tensor and telemetry launches the
    kernel's telemetry instance (never the plain version) and returns the
    fourth output, equal to the CPU entry point's."""
    traces = _traces(800, 2, 1000, cuda_device)
    groups = generators.tenant_groups(800, 4)
    call = dict(kind="tinylfu", n_objects=800, capacity=30, telemetry_window=64, n_groups=4, groups=groups)
    instance = port_kernel.instance_of("cache_sim/tinylfu", 64, 4)
    before = port_kernel.LAUNCHES[instance]
    card = ops.cache_sim(traces, **call)
    assert port_kernel.LAUNCHES[instance] == before + 1 and len(card) == 4 and card[3].is_cuda
    cpu = ops.cache_sim(traces.cpu(), device="cpu", **call)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


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


def _plain_on_cpu(traces, **kw):
    """The plain version of a call on the CPU (the same contract; cheaper than on the card
    for the long traces below)."""
    return port_kernel.cache_sim_plain(traces.cpu(), **kw)


def _assert_equal_to_cpu(got, want):
    assert set(got) - {"argmins"} == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind,extra", [("lru", {}), ("lfu", {}), ("plfua_dyn", dict(hot_size=40_000, refresh=9_000))])
def test_heap_moves_into_device_memory_in_byte_mode(cuda_device, kind, extra):
    """Unit sizes under a budget of 33,000 bytes: the heap's 33,000 slots pass the 29,056
    that shared memory holds (28,540 for plfua_dyn, whose sketch comes first), and a sweep
    over all 40,000 ids (every one hot for plfua_dyn, through four refreshes) fills the
    cache past them (the heap moves to device memory) before Zipf traffic evicts; exact
    against the plain version."""
    n, budget = 40_000, 33_000
    rng = np.random.default_rng(3)
    sweep = np.stack([rng.permutation(n) for _ in range(2)])
    tail = np.stack([zipf.sample_trace(n, 5_000, seed=9 + i) for i in range(2)])
    traces = torch.as_tensor(np.concatenate([sweep, tail], axis=1).astype(np.int32), device=cuda_device)
    kw = dict(kind=kind, n_objects=n, capacity=10, capacity_bytes=budget, sizes=np.ones(n, np.int32), **extra)
    plan = port_kernel.heap_plan(port_kernel.spec_of(kind, n, 10, capacity_bytes=budget, **extra), (1, 1))
    assert plan.slots == budget and plan.can_move and not plan.rows_shared
    got = port_kernel.cache_sim_cuda(traces, **kw)
    assert int(got["in_cache"].sum(dim=1).max()) > plan.shared_slots
    _assert_equal_to_cpu(got, _plain_on_cpu(traces, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,cap,rows_shared", [
    # rows (8 B an id) and heap (8 B a slot) fill the 232,448 bytes exactly, and one slot more
    ("lfu", 20_000, 9_056, True), ("lfu", 20_000, 9_057, False),
    ("plfua", 20_000, 9_056, True), ("plfua", 20_000, 9_057, False),
    # gdsf's heap has N slots: 16 B an id
    ("gdsf", 14_528, 300, True), ("gdsf", 14_529, 300, False),
])
def test_heap_rows_on_both_sides_of_the_shared_memory_limit(cuda_device, kind, n, cap, rows_shared):
    """The same policy with its rows in shared memory and, one id or slot further, in device
    memory: both exact against the plain version."""
    plan = port_kernel.heap_plan(port_kernel.spec_of(kind, n, cap), (1, 1))
    assert plan.rows_shared == rows_shared and not plan.can_move
    assert (plan.shared_bytes == port_kernel.SHARED_BYTES) == rows_shared
    traces = _traces(n, 2, 3_000, cuda_device, seed=4)
    kw = dict(kind=kind, n_objects=n, capacity=cap)
    _assert_equal_to_cpu(port_kernel.cache_sim_cuda(traces, **kw), _plain_on_cpu(traces, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,cap,kw,shared", [
    # arc: tags (a byte an id, 8-byte aligned) and links (8 B an id) fill the 232,448 bytes at N = 25,827
    ("arc", 25_827, 200, {}, True), ("arc", 25_828, 200, {}, False),
    # tinylfu: heap 320 B and sketch 4,096 B leave the rows 8 B an id up to N = 28,504 ...
    ("tinylfu", 28_504, 40, dict(window=700), True), ("tinylfu", 28_505, 40, dict(window=700), False),
    # ... and a heap of 8,000 B leaves a sketch of width 14,028 exactly its room
    ("tinylfu", 100_000, 1_000, dict(window=900, sketch_width=14_028), True),
    ("tinylfu", 100_000, 1_000, dict(window=900, sketch_width=14_029), False),
])
def test_scan_programs_on_both_sides_of_the_shared_memory_limit(cuda_device, kind, n, cap, kw, shared):
    """arc's tags and links and tinylfu's rows or sketch in shared memory and, one id or counter
    further, in device memory: exact against the plain version (the sketch cases on a
    scan trace that fills the cache and ages the sketch four times)."""
    spec = port_kernel.spec_of(kind, n, cap, **kw)
    if kind == "arc":
        plan = port_kernel.arc_plan(spec)
        assert plan.shared == shared
    else:
        plan = port_kernel.heap_plan(spec)
        assert (plan.sketch_shared if "sketch_width" in kw else plan.rows_shared) == shared
    assert (plan.shared_bytes == port_kernel.SHARED_BYTES) == shared
    if "sketch_width" in kw:
        traces = torch.as_tensor(generators.scan(n, 2, 4_000, seed=4, n_sweeps=3, sweep_len_frac=0.2),
                                 device=cuda_device)
    else:
        traces = _traces(n, 2, 3_000, cuda_device, seed=4)
    call = dict(kind=kind, n_objects=n, capacity=cap, **kw)
    _assert_equal_to_cpu(port_kernel.cache_sim_cuda(traces, **call), _plain_on_cpu(traces, **call))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,cap,kw,where,shared", [
    # wlfu: heap and rows fill the 232,448 bytes exactly, as lfu's, and one slot more
    ("wlfu", 20_000, 9_056, dict(window=500), "rows_shared", True),
    ("wlfu", 20_000, 9_057, dict(window=500), "rows_shared", False),
    # plfua_dyn (232,416 bytes beside its 32 static ones): a heap of 8,000 B leaves a sketch of
    # width 14,026 exactly its room (the hot mask joins in its place one counter further) ...
    ("plfua_dyn", 100_000, 1_000, dict(refresh=700, sketch_width=14_026), "sketch_shared", True),
    ("plfua_dyn", 100_000, 1_000, dict(refresh=700, sketch_width=14_027), "sketch_shared", False),
    # ... at N = 99,968 width 7,778 leaves the mask (99,968 B) exactly its room ...
    ("plfua_dyn", 99_968, 1_000, dict(refresh=700, sketch_width=7_778), "hot_shared", True),
    ("plfua_dyn", 99_968, 1_000, dict(refresh=700, sketch_width=7_779), "hot_shared", False),
    # ... and heap 320 B, sketch 4,096 B, mask and rows (9 B an id) fit up to N = 25,332
    ("plfua_dyn", 25_332, 40, dict(refresh=700, sketch_width=256), "rows_shared", True),
    ("plfua_dyn", 25_333, 40, dict(refresh=700, sketch_width=256), "rows_shared", False),
])
def test_wlfu_and_plfua_dyn_on_both_sides_of_the_shared_memory_limits(cuda_device, kind, n, cap, kw, where,
                                                                       shared):
    """wlfu's rows and plfua_dyn's sketch, hot mask and rows in shared memory and, one slot,
    counter or id further, in device memory: exact against the plain version over four
    refreshes."""
    plan = port_kernel.heap_plan(port_kernel.spec_of(kind, n, cap, **kw))
    assert getattr(plan, where) == shared and not plan.can_move
    static = port_kernel._REDUCE_BYTES if kind == "plfua_dyn" else 0
    assert plan.shared_bytes + static <= port_kernel.SHARED_BYTES
    traces = _traces(n, 2, 3_000, cuda_device, seed=4)
    call = dict(kind=kind, n_objects=n, capacity=cap, **kw)
    _assert_equal_to_cpu(port_kernel.cache_sim_cuda(traces, **call), _plain_on_cpu(traces, **call))


@pytest.mark.cuda
@pytest.mark.parametrize("trace_len", [2_100, 2_101])
@pytest.mark.parametrize("kw", [dict(refresh=700), dict(refresh=700, **BUDGET)])
def test_plfua_dyn_refresh_boundary_on_the_card(cuda_device, trace_len, kw):
    """A trace of three whole refresh periods, and one request more (a tail period that never
    refreshes): outputs and both series exact against the plain version, the last refresh in
    the last window."""
    n, cap = 5000, 40
    traces = torch.as_tensor(generators.multi_tenant(n, 3, trace_len, seed=5), device=cuda_device)
    groups = generators.tenant_groups(n, 4)
    for tel in ({}, dict(telemetry_window=300), dict(telemetry_window=300, n_groups=4, groups=groups)):
        call = dict(kind="plfua_dyn", n_objects=n, capacity=cap, **kw, **tel)
        got = port_kernel.cache_sim_cuda(traces, **call)
        want = port_kernel.cache_sim_plain(traces, **call)
        _assert_equal([got[k] for k in want], list(want.values()))
        if tel and not tel.get("n_groups"):
            fired = got["series"][..., telemetry_spec.METRICS.index("refreshes")]
            assert fired.sum(dim=1).tolist() == [3] * 3 and fired[:, -1].tolist() == [int(trace_len == 2_100)] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("sketch_shared", [True, False])
@pytest.mark.parametrize("doorkeeper", [0, 320])
def test_tinylfu_aging_with_the_sketch_in_either_memory(cuda_device, monkeypatch, sketch_shared, doorkeeper):
    """The warp's aging pass (halve the rows, clear the bloom) fires eight times in 3,000
    requests, with the sketch in shared memory and, where shared memory holds only the heap,
    in device memory: exact against the plain version, and the run differs from one that
    never ages."""
    n, cap, window = 5000, 40, 350
    call = dict(kind="tinylfu", n_objects=n, capacity=cap, doorkeeper=doorkeeper)
    if not sketch_shared:
        monkeypatch.setattr(port_kernel, "SHARED_BYTES", cap * 8)
    plan = port_kernel.heap_plan(port_kernel.spec_of(window=window, **call))
    assert plan.sketch_shared == sketch_shared and plan.shared_slots == cap
    traces = _traces(n, 3, 3000, cuda_device, seed=7)
    got = port_kernel.cache_sim_cuda(traces, window=window, **call)
    want = port_kernel.cache_sim_plain(traces, window=window, **call)
    _assert_equal([got[k] for k in want], list(want.values()))
    never = port_kernel.cache_sim_cuda(traces, window=10_000, **call)
    assert any(not torch.equal(got[k], never[k]) for k in want)


@pytest.mark.cuda
@pytest.mark.parametrize("shared_bytes", [port_kernel.SHARED_BYTES, 4_096, 64])
@pytest.mark.parametrize("kind,kw", [("lru", {}), ("lfu", {}), ("plfua", {}), ("gdsf", dict(sizes=LOGNORMAL)),
                                     ("lfu", BUDGET), ("gdsf", BUDGET), ("tinylfu", dict(window=400)),
                                     ("tinylfu", dict(window=400, doorkeeper=320)), ("arc", {}),
                                     ("wlfu", dict(window=500)), ("plfua_dyn", dict(refresh=700)),
                                     ("plfua_dyn", dict(refresh=700, **BUDGET))])
def test_heap_placements_give_the_same_outputs(cuda_device, monkeypatch, shared_bytes, kind, kw):
    """Less shared memory moves the rows, then the heap, into device memory (at 4,096 and
    64 bytes the heaps outgrow their shared slots mid-run; tinylfu's and plfua_dyn's
    sketch, plfua_dyn's hot mask and arc's tags and links leave shared memory too): the
    outputs stay the plain version's."""
    monkeypatch.setattr(port_kernel, "SHARED_BYTES", shared_bytes)
    traces = _traces(5000, 3, 3000, cuda_device, seed=7)
    call = dict(kind=kind, n_objects=5000, capacity=40, **kw)
    got = port_kernel.cache_sim_cuda(traces, **call)
    want = port_kernel.cache_sim_plain(traces, **call)
    _assert_equal([got[k] for k in want], list(want.values()))


def _gdsf_lowered_reprices(trace, n, cap):
    """How often a hit re-prices an id below its old score in object-count gdsf with unit
    sizes (int32, wrapping as the reference's): a plain-Python model of the step."""
    wrap = lambda v: (v + 2**31) % 2**32 - 2**31
    freq, score, cached, credit, lowered = [0] * n, [0] * n, set(), 0, 0
    for x in trace.tolist():
        hit = x in cached
        if not hit and len(cached) >= cap:
            victim = min(cached, key=lambda i: (score[i], i))
            credit = score[victim]
            cached.discard(victim)
        freq[x] += 1
        new = wrap(credit + wrap(freq[x] << 8))
        lowered += hit and new < score[x]
        score[x] = new
        cached.add(x)
    return lowered


@pytest.mark.cuda
def test_gdsf_reprice_that_lowers_a_key(cuda_device):
    """Two ids alternate under a capacity of 2 beside a hot id 0: every alternation evicts,
    the credit climbs past INT_MAX and wraps, and a hit on id 0 then re-prices it below its
    old score (the heap moves it up). Exact against the plain version."""
    n, cap, t = 3, 2, 16_000
    rows = []
    for seed in (1, 2):
        alternate = np.tile(np.arange(1, 3), t // 2)
        rows.append(np.where(np.random.default_rng(seed).random(t) < 0.5, 0, alternate))
        assert _gdsf_lowered_reprices(rows[-1], n, cap) > 0
    traces = torch.as_tensor(np.stack(rows).astype(np.int32), device=cuda_device)
    kw = dict(kind="gdsf", n_objects=n, capacity=cap)
    _assert_equal_to_cpu(port_kernel.cache_sim_cuda(traces, **kw), _plain_on_cpu(traces, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lru", "gdsf"])
@pytest.mark.parametrize("max_victims", [1, 2])
def test_heap_byte_loop_stops_at_max_victims(cuda_device, kind, max_victims):
    """Under the pareto budget the victim bound binds (the run differs from the default
    bound's), and each run equals the plain version."""
    n, cap = 5000, 40
    traces = _traces(n, 3, 3000, cuda_device, seed=7)
    kw = dict(kind=kind, n_objects=n, capacity=cap, sizes=PARETO, capacity_bytes=int(40 * PARETO.mean()))
    got = port_kernel.cache_sim_cuda(traces, max_victims=max_victims, **kw)
    want = port_kernel.cache_sim_plain(traces, max_victims=max_victims, **kw)
    _assert_equal([got[k] for k in want], list(want.values()))
    default = port_kernel.cache_sim_cuda(traces, **kw)
    assert any(not torch.equal(got[k], default[k]) for k in got)


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
    assert tm.power_w > 0 and tm.j_per_step > 0 and tm.card and tm.trace is None


@pytest.mark.cuda
def test_measure_profile_dir_traces_the_kernel(cuda_device, tmp_path):
    """The profiled call sees the kernel launched by the port's own library
    (CUPTI traces every kernel), or, where the sandbox's profiler sees no
    device activity, still writes its trace."""
    traces = _traces(1000, 2, 5000, cuda_device)
    tm = timing.measure(port_kernel.cache_sim_cuda, traces, steps=traces.numel(), repeats=1,
                        profile_dir=tmp_path, kind="lfu", n_objects=1000, capacity=20)
    assert tm.trace is not None and tm.trace.path.exists()
    if tm.trace.kernels:
        assert 0 < tm.trace.busy_s <= tm.trace.span_s and 0 <= tm.trace.idle_share < 1


# ------------------------------------------------------------ flash attention
# (B, H, KH, Sq, Skv, D, causal, dtype, kv_len): tests/test_kernels_flash.py's
# SWEEP, its kv_len case, the served model's shapes at a shorter context in
# both dtypes, and the edges of the prefill's 128-row, 64-key tiles and of the
# decode splits, in both dtypes
FLASH_EDGES = [
    (1, 4, 2, 17, 17, 64, True, None),      # prefill rows not a multiple of the query tile
    (1, 4, 2, 100, 100, 64, True, None),
    (1, 4, 2, 100, 160, 64, True, 130),     # causal with kv_len < Skv, Sq != Skv
    (1, 4, 4, 200, 90, 64, False, None),    # Sq > Skv, GQA group 1
    (1, 16, 2, 150, 150, 64, True, None),   # GQA group 8
    (1, 4, 2, 130, 130, 16, True, None),    # D = 16
    (1, 4, 2, 130, 200, 128, False, 180),   # D = 128: two 64-column boxes a row
    (1, 15, 5, 1, 2_056, 64, False, 1),     # decode: kv_len 1
    (1, 15, 5, 1, 530, 64, False, 40),      # kv_len below one split's keys: one split
    (1, 15, 5, 1, 2_056, 64, False, 2_049), # kv_len not a multiple of the 27 splits
    (1, 15, 5, 1, 48, 64, False, None),     # Skv below one split's keys: one split
    (8, 32, 32, 1, 300, 64, False, None),   # more kv heads than SMs: one split
    (2, 16, 2, 16, 700, 16, True, 650),     # 128 rows of a kv head: 4 row groups, causal
    (1, 4, 4, 130, 130, 192, True, None),   # D = 192 (MLA): three 64-column boxes a row
    (1, 2, 2, 200, 300, 192, False, 250),   # D = 192, kv_len < Skv, non-causal
    (1, 8, 8, 12, 12, 192, True, None),     # a 12-token MLA prompt: the decode instance, causal
    (1, 16, 16, 1, 2_056, 192, False, 2_049),  # D = 192 decode over splits
    (1, 20, 20, 1_500, 1_500, 64, False, None),  # whisper's encoder: non-causal, a partial last key tile
    (1, 20, 20, 4, 1_500, 64, False, None),     # cross-attention from a 4-row prompt: the decode instance
    (1, 20, 20, 128, 1_500, 64, False, None),   # cross-attention, Sq != Skv, non-causal: the prefill instance
    (1, 20, 20, 1, 1_500, 64, False, 1_500),    # the cross decode over the whole source
    (1, 20, 20, 1, 448, 64, False, 133),        # the decoder's decode against its self cache of 448
    (1, 32, 8, 2_048, 2_048, 128, True, None),  # llava's prefill over prefix and text
    (1, 32, 8, 1, 2_056, 128, False, 2_049),    # llava's decode
]
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, True, torch.float32, None),
    (2, 4, 2, 128, 128, 64, True, torch.float32, None),
    (1, 8, 2, 256, 256, 128, True, torch.bfloat16, None),
    (1, 2, 1, 96, 160, 64, True, torch.float32, None),
    (1, 2, 2, 128, 384, 64, False, torch.float32, None),
    (2, 3, 3, 64, 64, 32, True, torch.bfloat16, None),
    (1, 2, 2, 1, 512, 64, False, torch.float32, None),
    (1, 16, 8, 1, 300, 128, False, torch.bfloat16, None),
    (1, 4, 4, 1, 256, 64, False, torch.float32, 100),
    (2, 4, 2, 9, 40, 16, True, torch.float32, 30),
] + [(1, 15, 5, sq, skv, 64, sq > 1, dtype, kv_len)
     for sq, skv, kv_len in ((520, 520, None), (1, 530, 1), (1, 530, 517))
     for dtype in (torch.bfloat16, torch.float32)] + [
    (*case[:7], dtype, case[7]) for case in FLASH_EDGES for dtype in (torch.bfloat16, torch.float32)]
#: (atol, rtol) of the kernel against its plain version
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2**-7)}


@pytest.fixture
def exact_f32():
    """f32 products in full f32 on the card while the plain version runs (TF32 off)."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal,dtype,kv_len", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda_device, exact_f32, b, h, kh, sq, skv, d, causal, dtype, kv_len):
    """The kernel against its plain version on the card, garbage past kv_len
    included. Both accumulate the same f32 function (p in f32) from the same
    inputs: 2e-5 in float32 (summation order; TF32 off), and in bfloat16 one
    rounding of the output, 1 to 2 ulps: rtol 2**-7 with an absolute floor
    of 1e-4."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(sq * 7 + skv)
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda_device).to(dtype)
    k = torch.randn(b, kh, skv, d, generator=gen, device=cuda_device).to(dtype)
    v = torch.randn(b, kh, skv, d, generator=gen, device=cuda_device).to(dtype)
    if kv_len is not None:
        k[:, :, kv_len:] = 1e6
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_cuda(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {**before, fa.instance_of(sq): before[fa.instance_of(sq)] + 1}
    want = fa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    atol, rtol = FLASH_TOL[dtype]
    assert got.is_cuda and got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def _flash_inputs(b, h, kh, sq, skv, d, dtype, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, n, s, d, generator=gen, device=device).to(dtype)
            for n, s in ((h, sq), (kh, skv), (kh, skv))]


@pytest.mark.cuda
def test_flash_decode_twice_in_a_row_resets_its_merge_counters(cuda_device):
    """Two decode launches in a row on one stream, at the served shape (27
    splits merged by the last block of each kv head): the second finds its
    counters at 0 and gives the first's output bit for bit, and both leave
    every counter at 0."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    q, k, v = _flash_inputs(1, 15, 5, 1, 2_056, 64, torch.bfloat16, 5, cuda_device)
    first = fa.flash_attention_cuda(q, k, v, causal=False, kv_len=2_000)
    second = fa.flash_attention_cuda(q, k, v, causal=False, kv_len=2_000)
    torch.cuda.synchronize()
    torch.testing.assert_close(second, first, rtol=0, atol=0)
    want = fa.flash_attention_plain(q, k, v, causal=False, kv_len=2_000)
    torch.testing.assert_close(first.float(), want.float(), atol=1e-4, rtol=2**-7)
    assert fa._COUNTERS and all(int(c.abs().sum()) == 0 for c in fa._COUNTERS.values())


@pytest.mark.cuda
def test_flash_tolerance_rejects_p_rounded_to_bf16(cuda_device, exact_f32):
    """At (1, 15, 5, 520) bf16 causal, the kernel (p as a bf16 pair into the
    tensor cores) passes the bf16 tolerance against the plain version (p in
    f32), and a deliberately wrong plain version that rounds p to bf16 before
    P V fails it: the tolerance tells the two designs apart."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    q, k, v = _flash_inputs(1, 15, 5, 520, 520, 64, torch.bfloat16, 520 * 7 + 520, cuda_device)
    want = fa.flash_attention_plain(q, k, v, causal=True).float()
    kq, vq = (x.repeat_interleave(3, dim=1).float() for x in (k, v))
    s = (q.float() @ kq.transpose(-1, -2)) / 8.0
    s = s.masked_fill(torch.ones(520, 520, dtype=torch.bool, device=cuda_device).triu(1), -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    wrong = ((p.to(torch.bfloat16).float() @ vq) / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    got = fa.flash_attention_cuda(q, k, v, causal=True).float()

    def ratio(x):
        return float(((x - want).abs() / (1e-4 + 2**-7 * want.abs())).max())

    assert ratio(got) <= 1 < ratio(wrong)


@pytest.mark.cuda
def test_flash_ops_launches_or_raises_on_the_card(cuda_device):
    """ops.flash_attention on CUDA tensors runs the kernel (counted) and
    raises on what it does not take: an unsupported head dim, tensors on two
    devices, a bf16 row stride that the kernel's 16-byte reads cannot take."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as flash_ops

    q = torch.randn(1, 2, 8, 64, device=cuda_device)
    before = sum(fa.LAUNCHES.values())
    flash_ops.flash_attention(q, q, q)
    assert sum(fa.LAUNCHES.values()) == before + 1
    odd = torch.randn(1, 2, 8, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_ops.flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, q.cpu(), q)
    odd_rows = torch.randn(1, 2, 8, 68, device=cuda_device).to(torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16 bytes at a time"):
        flash_ops.flash_attention(odd_rows, odd_rows, odd_rows)
    assert sum(fa.LAUNCHES.values()) == before + 1


@pytest.mark.cuda
def test_reduced_engine_on_the_card_matches_cpu(cuda_device, exact_f32):
    """The reduced smollm-360m (float32) served on the card, every attention
    call through the kernel, gives the CPU run's tokens and stats; the kernel
    runs once a layer a prefill and a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import build
    from repro_torch.serving import ContentCache, Request, ServeEngine

    cfg = get_config("smollm-360m").reduced()
    card = build(cfg, device=cuda_device).init(torch.Generator(device=cuda_device).manual_seed(0))
    cpu = build(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(0)
    # 8 and 16 tokens take the dense branch on the CPU, 32 the chunked one
    prompts = {i: rng.integers(0, cfg.vocab_size, (8, 16, 32)[i % 3]).astype(np.int32) for i in range(20)}
    reqs = [Request(int(x), prompts[int(x)], max_new=4) for x in zipf.sample_trace(20, 30, seed=1)]
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        engine = ServeEngine(model, cache_len=40, content_cache=ContentCache(5, policy="plfua", n_objects=20))
        before = sum(fa.LAUNCHES.values())
        runs[name] = ([r.new_tokens for r in engine.run(reqs)], engine.report(), sum(fa.LAUNCHES.values()) - before)
    (card_tokens, card_report, launches), (cpu_tokens, cpu_report, cpu_launches) = runs["card"], runs["cpu"]
    assert card_tokens == cpu_tokens
    assert {k: v for k, v in card_report.items() if k != "mgmt_time_s"} == \
        {k: v for k, v in cpu_report.items() if k != "mgmt_time_s"}
    prefills = card_report["cache_misses"]
    assert cpu_launches == 0 and launches == cfg.n_layers * (prefills + card_report["decode_tokens"])


# ------------------------------------------------------------------ the fleet
def _fleet_topo(kind, **kw):
    from repro_torch import fleet

    return fleet.tree(n_objects=128, widths=(4, 2, 1), kinds=kind, capacities=(4, 9, 23), **kw)


def _same_tree(got, want, path="out"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, tuple):
        for i, (a, b) in enumerate(zip(got, want)):
            _same_tree(a, b, f"{path}[{i}]")
    else:
        assert got.is_cuda and got.dtype == want.dtype, path
        assert torch.equal(got.cpu(), want), path


FLEET_BYTES = generators.object_sizes(128, dist="lognormal", corr=0.5, seed=11, median=64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kw", [
    ("lfu", {}), ("plfua_dyn", dict(refresh=200)), ("arc", {}),
    ("gdsf", dict(capacity_bytes=tuple(int(c * FLEET_BYTES.mean()) for c in (4, 9, 23)))),
])
def test_fleet_on_the_card_equals_the_cpu(cuda_device, kind, kw):
    """The level-major engine on the card gives the CPU's results exactly,
    with grouped telemetry on (tests/test_torch_fleet.py's size)."""
    from repro_torch import fleet, telemetry

    topo = _fleet_topo(kind, **kw)
    traces = generators.multi_tenant(128, 2, 1_200, seed=29, n_tenants=4)
    assignments = topo.assignment(traces)
    spec = telemetry.TelemetrySpec(100, 4)
    groups = generators.tenant_groups(128, 4)
    args = (topo, traces, assignments, spec, FLEET_BYTES, groups)
    _same_tree(fleet.simulate_fleet_batch(*args, device=cuda_device), fleet.simulate_fleet_batch(*args, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hash", "sticky", "round_robin"])
def test_route_level_on_the_card_equals_numpy(cuda_device, mode):
    from repro_torch.cdn import router

    rng = np.random.default_rng(5)
    trace = rng.integers(0, 2**31 - 1, size=(3, 20_000), dtype=np.int64).astype(np.int32)
    for n, seed in ((1, 0), (2, 1), (7, 3), (1_000, 2**31 - 1)):
        want = router.route_level(trace, n, mode, session_len=64, seed=seed)
        got = router.route_level(torch.as_tensor(trace, device=cuda_device), n, mode, session_len=64, seed=seed)
        assert got.is_cuda and got.dtype == torch.int32
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["stationary", "churn", "flash_crowd", "diurnal", "multi_tenant", "scan"])
def test_device_generators_on_the_card(cuda_device, scenario):
    """The device generators' contracts on the card (tests/test_torch_device_workloads.py)."""
    from repro_torch.workloads.device import DeviceTraceSpec, gen_sample, make_traces_device, sample_key

    make = lambda seed, s=3: make_traces_device(DeviceTraceSpec(scenario, 400, n_samples=s, trace_len=6_000,
                                                                seed=seed), device=cuda_device)
    a = make(5)
    assert a.is_cuda and a.shape == (3, 6_000) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 400
    assert torch.equal(a, make(5)) and not torch.equal(a, make(6))
    assert bool((a[0] != a[1]).any())
    dspec = DeviceTraceSpec(scenario, 400, n_samples=3, trace_len=6_000, seed=5)
    assert torch.equal(gen_sample(dspec, sample_key(dspec, 2), device=cuda_device), a[2])
    assert torch.equal(make(5, s=1)[0], a[0])
    tr = a.cpu().numpy()
    if scenario == "churn":
        share = np.sort(np.bincount(tr.ravel(), minlength=400))[::-1][:40].sum() / tr.size
    else:
        share = (tr < 40).mean()
    assert share > 0.25


# ------------------------------------------------------ the placed engine
@pytest.mark.cuda
@pytest.mark.parametrize("placements,kind,kw", [
    ("lcd", "plfu", {}),
    ("admit", "arc", {}),
    ("prob(0.5)", "tinylfu", {}),
    (("lcd", "admit", "prob(0.5)"), ("lru", "plfua_dyn", "plfua_dyn"), dict(refresh=(0, 150, 225))),
    ("admit", "gdsf", dict(capacity_bytes=tuple(int(c * FLEET_BYTES.mean()) for c in (4, 9, 23)))),
])
def test_placed_fleet_on_the_card_equals_the_cpu(cuda_device, placements, kind, kw):
    """The time-major placed engine on the card gives the CPU's results exactly, placement
    sketches and grouped telemetry included (tests/test_torch_placement.py's size)."""
    from repro_torch import fleet, telemetry

    topo = _fleet_topo(kind, placements=placements, **kw)
    assert topo.has_placement
    traces = generators.multi_tenant(128, 2, 900, seed=31, n_tenants=4)
    assignments = topo.assignment(traces)
    args = (topo, traces, assignments, telemetry.TelemetrySpec(100, 4), FLEET_BYTES, generators.tenant_groups(128, 4))
    got = fleet.simulate_fleet_batch(*args, device=cuda_device)
    _same_tree(got, fleet.simulate_fleet_batch(*args, device="cpu"))
    assert int(sum(t["evictions"].sum() for t in got["tiers"])) > 0


@pytest.mark.cuda
def test_coin_table_on_the_card_equals_numpy(cuda_device):
    from repro_torch.fleet import placement

    pls = ("prob(0.5)", "lcd", "prob(0.01)", "prob(0.99)")
    table = placement.coin_table(pls, 1 << 20, cuda_device)
    assert table.is_cuda and table.shape == (4, 1 << 20)
    t = np.arange(1 << 20)
    for l, pl in enumerate(pls):
        kind, p = placement.parse(pl)
        want = placement.prob_fill(t, l, p) if kind == "prob" else np.zeros(t.size, bool)
        np.testing.assert_array_equal(table[l].cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plfua", "plfua_dyn", "tinylfu"])
def test_hierarchy_on_the_card_equals_the_cpu(cuda_device, kind):
    from repro_torch import cdn

    hspec = cdn.two_tier(kind, 128, n_edges=4, edge_capacity=7, parent_capacity=24,
                         refresh=150 if kind == "plfua_dyn" else 0)
    traces = generators.churn(128, 3, 1_000, seed=13)
    assignments = hspec.assignment(traces)
    got = cdn.simulate_hierarchy_batch(hspec, traces, assignments, device=cuda_device)
    _same_tree(got, cdn.simulate_hierarchy_batch(hspec, traces, assignments, device="cpu"))
    rep = cdn.hierarchy_report(hspec, got)
    assert rep.n_requests == 3_000 and 0.0 < rep.total_chr <= 1.0
