"""The port's PyTorch simulator against the reference's jitted one.

``torch_cache`` with ``device="cpu"`` must equal ``jax_cache`` exactly on the
hit series and on every state entry (in_cache, count, freq or lru's last/t,
the hot mask, wlfu's ring and ptr, the sketch rows, inserts, tinylfu's seen
and doorkeeper bloom, gdsf's score and credit, arc's lst/stamp/p/t), for all
nine kinds, and through the fill gate (arc's park and skip paths included), a
traced capacity and a state handed over mid-trace. Byte mode has its own file,
tests/test_torch_bytes.py. Everything compared is an integer or a bool, so the
tolerance is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads
from repro.core import jax_cache, policies
from repro.core import zipf as ref_zipf
from repro_torch.core import torch_cache

KINDS = ("lru", "lfu", "plfu", "plfua", "wlfu", "tinylfu", "plfua_dyn", "gdsf", "arc")
# small windows, refresh periods and sketches, so that the ring wraps, the
# sketch ages and the hot set refreshes within the short traces below (the
# mid-trace handover at 333 = 3 x 111 falls on a refresh boundary)
KIND_KW = {
    "wlfu": dict(window=16),
    "tinylfu": dict(window=50, sketch_width=64),
    "plfua_dyn": dict(refresh=111, sketch_width=64),
}

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
    ("plfua", 130, 1, 2, 300, dict(hot_size=7)),
    ("wlfu", 64, 9, 3, 400, dict(window=48)),
    ("wlfu", 130, 3, 2, 500, dict(window=33)),
    ("tinylfu", 64, 9, 3, 400, dict(window=48, sketch_width=64)),
    ("tinylfu", 300, 20, 2, 500, dict(window=77, sketch_width=100)),
    ("tinylfu", 64, 9, 2, 400, {}),
    ("plfua_dyn", 64, 9, 3, 400, dict(refresh=97, sketch_width=64)),
    ("plfua_dyn", 130, 3, 2, 500, dict(refresh=50, sketch_width=96, hot_size=7)),
    ("plfua_dyn", 16, 1, 2, 300, dict(refresh=30, sketch_width=64)),
    # the doorkeeper, and a window of 1 (the ring overwrites its only slot)
    ("tinylfu", 64, 9, 2, 500, dict(window=60, sketch_width=64, doorkeeper=128)),
    ("tinylfu", 40, 5, 2, 300, dict(window=1, sketch_width=33, doorkeeper=1)),
    ("wlfu", 40, 5, 2, 300, dict(window=1)),
    # gdsf (unit sizes) and arc over the same shapes: cap = 1, cap == N, N crossing 128
    ("gdsf", 64, 9, 3, 400, {}),
    ("gdsf", 130, 3, 2, 500, {}),
    ("gdsf", 16, 1, 2, 300, {}),
    ("arc", 64, 9, 3, 400, {}),
    ("arc", 130, 3, 2, 500, {}),
    ("arc", 16, 1, 2, 300, {}),
    ("arc", 128, 128, 2, 300, {}),
    ("arc", 200, 50, 2, 600, {}),
]


def _traces(n, s, t, seed=100):
    return np.stack([ref_zipf.sample_trace(n, t, seed=seed + i) for i in range(s)]).astype(np.int32)


def _specs(kind, n, cap, **kw):
    return (
        torch_cache.PolicySpec(kind=kind, n_objects=n, capacity=cap, **kw),
        jax_cache.PolicySpec(kind=kind, n_objects=n, capacity=cap, **kw),
    )


def _assert_state_equal(port_state, ref_state):
    ref = {k: np.asarray(v) for k, v in ref_state.items()}
    assert set(port_state) == set(ref)
    for k, v in port_state.items():
        assert v.numpy().dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("kind,n,cap,s,t,kw", SWEEP)
def test_simulate_batch_matches_jax(kind, n, cap, s, t, kw):
    port_spec, ref_spec = _specs(kind, n, cap, **kw)
    traces = _traces(n, s, t)
    hits, state = torch_cache.simulate_batch(port_spec, traces, device="cpu")
    assert hits.shape == (s, t) and hits.dtype == torch.bool
    for i in range(s):
        ref_hits, ref_state = jax_cache.simulate(ref_spec, jnp.asarray(traces[i]))
        np.testing.assert_array_equal(hits[i].numpy(), np.asarray(ref_hits))
        _assert_state_equal({k: v[i] for k, v in state.items()}, ref_state)
    np.testing.assert_array_equal(
        hits.numpy(), np.asarray(jax_cache.simulate_batch(ref_spec, jnp.asarray(traces)))
    )


@pytest.mark.parametrize("kind", KINDS)
def test_simulate_single_trace_matches_jax(kind):
    port_spec, ref_spec = _specs(kind, 40, 6, **KIND_KW.get(kind, {}))
    trace = _traces(40, 1, 500, seed=3)[0]
    hits, state = torch_cache.simulate(port_spec, trace, device="cpu")
    ref_hits, ref_state = jax_cache.simulate(ref_spec, jnp.asarray(trace))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(ref_hits))
    _assert_state_equal(state, ref_state)
    assert float(torch_cache.chr_of(hits)) == pytest.approx(float(jax_cache.chr_of(ref_hits)))


@pytest.mark.parametrize("kind", KINDS)
def test_metadata_and_evictions_match_jax(kind):
    port_spec, ref_spec = _specs(kind, 64, 9, **KIND_KW.get(kind, {}))
    trace = _traces(64, 1, 3000, seed=7)[0]
    hits, state = torch_cache.simulate(port_spec, trace, device="cpu")
    ref_hits, ref_state = jax_cache.simulate(ref_spec, jnp.asarray(trace))
    assert int(torch_cache.metadata_entries(port_spec, state)) == int(
        jax_cache.metadata_entries(ref_spec, ref_state)
    )
    evictions = torch_cache.eviction_count(port_spec, hits, trace, state)
    assert evictions == jax_cache.eviction_count(ref_spec, ref_hits, trace, ref_state)
    assert evictions > 0


@pytest.mark.parametrize("kind", KINDS)
def test_hit_series_matches_python_reference(kind):
    n, cap = 50, 7
    trace = _traces(n, 1, 1500, seed=21)[0]
    kw = KIND_KW.get(kind, {})
    hits, state = torch_cache.simulate(torch_cache.PolicySpec(kind, n, cap, **kw), trace, device="cpu")
    pol = policies.make_policy(kind, cap, n_objects=n, **kw)
    expected = np.array([pol.request(int(x)) for x in trace])
    np.testing.assert_array_equal(hits.numpy(), expected)
    np.testing.assert_array_equal(state["in_cache"].numpy(), [pol.contains(i) for i in range(n)])


@pytest.mark.parametrize("kind", KINDS)
def test_state_carried_from_jax_mid_trace(kind):
    """JAX runs the first half, the port finishes from JAX's state: the result
    equals the one-shot JAX run. plfua_dyn's refresh cadence counts from the
    start of each run, so its handover falls on a refresh boundary."""
    port_spec, ref_spec = _specs(kind, 90, 8, **KIND_KW.get(kind, {}))
    trace = _traces(90, 1, 800, seed=31)[0]
    half = 333
    first_hits, mid = jax_cache.simulate(ref_spec, jnp.asarray(trace[:half]))
    mid = {k: np.asarray(v) for k, v in mid.items()}
    carried = torch_cache.state_from_numpy(port_spec, mid, device="cpu")
    rest_hits, state = torch_cache.simulate(port_spec, trace[half:], state=carried, device="cpu")
    ref_hits, ref_state = jax_cache.simulate(ref_spec, jnp.asarray(trace))
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(first_hits), rest_hits.numpy()]), np.asarray(ref_hits)
    )
    _assert_state_equal(state, ref_state)
    # the handed-over state was copied, not updated in place
    _assert_state_equal(carried, mid)
    back = torch_cache.state_to_numpy(port_spec, state)
    assert {k: v.dtype for k, v in back.items()} == {k: np.asarray(v).dtype for k, v in ref_state.items()}


def test_state_from_numpy_keeps_a_batched_state():
    port_spec, ref_spec = _specs("plfu", 30, 4)
    traces = _traces(30, 3, 200, seed=5)
    ref = jax.vmap(lambda tr: jax_cache.simulate(ref_spec, tr)[1])(jnp.asarray(traces))
    port = torch_cache.state_from_numpy(port_spec, {k: np.asarray(v) for k, v in ref.items()}, device="cpu")
    assert port["freq"].shape == (3, 30) and port["count"].shape == (3,)
    with pytest.raises(ValueError, match="state keys"):
        torch_cache.state_from_numpy(port_spec, {"in_cache": np.zeros(30, bool)}, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_step_fill_gate_and_traced_cap_match_jax(kind):
    """Per-sample ``fill`` (False steps included) and a per-sample ``cap``
    against the reference step vmapped over samples."""
    n, s, t = 40, 3, 300
    port_spec, ref_spec = _specs(kind, n, 6, **KIND_KW.get(kind, {}))
    traces = _traces(n, s, t, seed=9)
    fills = np.random.default_rng(1).random((s, t)) < 0.6
    caps = np.array([1, 4, 9], np.int32)

    def ref_run(trace, fill, cap):
        state = jax_cache.init_state(ref_spec)
        return jax.lax.scan(
            lambda st, xf: jax_cache.step(ref_spec, st, xf[0], cap=cap, fill=xf[1]),
            state,
            (trace, fill),
        )

    ref_state, ref_hits = jax.vmap(ref_run)(jnp.asarray(traces), jnp.asarray(fills), jnp.asarray(caps))
    state = torch_cache.init_state(port_spec, n_samples=s, device="cpu")
    hits = []
    for i in range(t):
        state, hit = torch_cache.step(
            port_spec, state, torch.as_tensor(traces[:, i]),
            cap=torch.as_tensor(caps), fill=torch.as_tensor(fills[:, i]),
        )
        hits.append(hit.clone())
    np.testing.assert_array_equal(torch.stack(hits, dim=1).numpy(), np.asarray(ref_hits))
    _assert_state_equal(state, ref_state)


def test_masked_argmin_ties_to_lowest_id():
    rng = np.random.default_rng(4)
    values = rng.integers(0, 3, size=(50, 17)).astype(np.int32)
    mask = rng.random((50, 17)) < 0.5
    mask[0] = False  # empty mask: id 0, as the reference
    port = torch_cache._masked_argmin(torch.as_tensor(values), torch.as_tensor(mask))
    ref = jax.vmap(jax_cache._masked_argmin)(jnp.asarray(values), jnp.asarray(mask))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# wlfu, tinylfu and plfua_dyn under a byte budget, gdsf and arc: ported, so
# each runs as the reference, and only an unported option (telemetry) raises
@pytest.mark.parametrize(
    "kind,spec_kw",
    [
        pytest.param("wlfu", dict(capacity_bytes=64), id="wlfu"),
        pytest.param("tinylfu", dict(capacity_bytes=64), id="tinylfu"),
        pytest.param("plfua_dyn", dict(capacity_bytes=64), id="plfua_dyn"),
        pytest.param("gdsf", {}, id="gdsf"),
        pytest.param("arc", {}, id="arc"),
    ],
)
def test_unported_kinds_raise(kind, spec_kw):
    spec = torch_cache.PolicySpec(kind=kind, n_objects=16, capacity=4, window=4, **spec_kw)
    ref_spec = jax_cache.PolicySpec(kind=kind, n_objects=16, capacity=4, window=4, **spec_kw)
    trace = _traces(16, 1, 200, seed=12)[0]
    sizes = np.random.default_rng(6).integers(1, 20, 16).astype(np.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        torch_cache.simulate(spec, trace, telemetry=object(), device="cpu")
    hits, state = torch_cache.simulate(spec, trace, sizes=sizes, device="cpu")
    ref_hits, ref_state = jax_cache.simulate(ref_spec, jnp.asarray(trace), None, jnp.asarray(sizes))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(ref_hits))
    _assert_state_equal(state, ref_state)


@pytest.mark.parametrize(
    "spec_kw,call_kw",
    [
        (dict(capacity_bytes=64), {}),
        ({}, dict(sizes=np.ones(16, np.int32))),
        ({}, dict(telemetry=object())),
        ({}, dict(groups=np.zeros(16, np.int32))),
    ],
)
def test_unported_options_raise(spec_kw, call_kw):
    """Telemetry and its groups raise; a byte budget and a sizes row (which
    plfu, not size-aware, ignores) run as the reference."""
    spec = torch_cache.PolicySpec(kind="plfu", n_objects=16, capacity=4, **spec_kw)
    traces = _traces(16, 2, 100, seed=8)
    if "telemetry" in call_kw or "groups" in call_kw:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            torch_cache.simulate_batch(spec, traces, device="cpu", **call_kw)
        return
    hits, _ = torch_cache.simulate_batch(spec, traces, device="cpu", **call_kw)
    ref_spec = jax_cache.PolicySpec(kind="plfu", n_objects=16, capacity=4, **spec_kw)
    ref = jax_cache.simulate_batch(ref_spec, jnp.asarray(traces), None, call_kw.get("sizes"))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(ref))


def test_gdsf_sized_matches_jax_and_python_reference():
    """gdsf's score under a heavy-tailed size row, object-count capacity:
    state against the scan, hits and contents against the Python policy."""
    n, cap = 64, 8
    sizes = workloads.object_sizes(n, dist="pareto", corr=0.5, seed=3, median=8, max_size=64)
    trace = _traces(n, 1, 800, seed=41)[0]
    port_spec, ref_spec = _specs("gdsf", n, cap)
    hits, state = torch_cache.simulate(port_spec, trace, sizes=sizes, device="cpu")
    ref_hits, ref_state = jax_cache.simulate(ref_spec, jnp.asarray(trace), None, jnp.asarray(sizes))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(ref_hits))
    _assert_state_equal(state, ref_state)
    pol = policies.make_policy("gdsf", cap, n_objects=n, sizes=sizes)
    np.testing.assert_array_equal(hits.numpy(), [pol.request(int(x)) for x in trace])
    np.testing.assert_array_equal(state["in_cache"].numpy(), [pol.contains(i) for i in range(n)])


def test_gdsf_int32_score_wraps_as_the_reference():
    """A frequency whose ``<< 8`` overflows int32, and a credit near the top
    of the range, wrap and floor exactly as jnp's int32 (a handed-over state
    puts them there)."""
    n, cap = 8, 2
    port_spec, ref_spec = _specs("gdsf", n, cap)
    sizes = np.array([3, 7, 1, 5, 2, 9, 4, 6], np.int32)
    mid = {k: np.asarray(v) for k, v in jax_cache.init_state(ref_spec).items()}
    mid["freq"] = np.array([2**23 + 5, 2**24 - 1, 7, 2**30, 0, 0, 0, 0], np.int32)
    mid["L"] = np.int32(2**31 - 100)
    trace = np.array([0, 1, 3, 2, 0, 4, 5, 1, 6, 7, 3, 0], np.int32)
    hits, state = torch_cache.simulate(
        port_spec, trace, sizes=sizes, state=torch_cache.state_from_numpy(port_spec, mid, device="cpu"),
        device="cpu")
    ref_state = {k: jnp.asarray(v) for k, v in mid.items()}
    ref_hits = []
    for x in trace:
        ref_state, hit = jax_cache.step(ref_spec, ref_state, jnp.int32(x), sizes=jnp.asarray(sizes))
        ref_hits.append(bool(hit))
    np.testing.assert_array_equal(hits.numpy(), ref_hits)
    _assert_state_equal(state, ref_state)
    # id 3 was repriced twice from a count whose << 8 leaves the int32 range
    assert int(state["freq"][3]) == 2**30 + 2


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = torch_cache.PolicySpec(kind="lfu", n_objects=16, capacity=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cache.simulate(spec, np.zeros(8, np.int32))
