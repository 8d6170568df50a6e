"""Byte mode of the port against the reference, on the CPU.

With ``capacity_bytes`` > 0 the limit is a byte budget over an ``(N,)`` size
row, and an insertion may evict up to ``max_victims`` least-key residents.
``torch_cache`` must equal ``jax_cache`` exactly (hits and every state entry,
the ``bytes`` ledger and ``inserts`` included) for all eight kinds the
reference runs under a budget, over both size catalogues, through a traced
budget and the fill gate and a state handed over mid-trace; the bounded loop
must abandon an object it cannot make room for, an object larger than the
budget must evict nothing, and unit sizes with ``capacity_bytes ==
capacity`` must reproduce object-count mode. ``ops.cache_sim(device="cpu")``
must equal the reference kernel in interpret mode for its byte-capable kinds,
and for gdsf scored by size under an object-count capacity. Everything
compared is an integer or a bool, so the tolerance is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads
from repro.core import jax_cache, registry
from repro.kernels.cache_sim import cache_sim as ref_cache_sim
from repro.kernels.cache_sim import ops as ref_ops
from repro_torch.core import torch_cache
from repro_torch.kernels.cache_sim import cache_sim as port_kernel
from repro_torch.kernels.cache_sim import ops

N, CAP, T = 64, 8, 500
# every kind the reference simulator runs under a byte budget (all but arc)
BYTE_KINDS = tuple(k for k in registry.names(jax=True) if k != "arc")
KNOBS = {"wlfu": {"window": 48}, "tinylfu": {"window": 120}, "plfua_dyn": {"refresh": 150}}


def _sizes(dist="lognormal", seed=3, n=N):
    return workloads.object_sizes(n, dist=dist, corr=0.5, seed=seed, median=8, max_size=64)


def _traces(s, t, seed, n=N):
    return workloads.make_traces("churn", n, n_samples=s, trace_len=t, seed=seed)


def _specs(kind, cap_bytes, max_victims=0, n=N, cap=CAP):
    kw = dict(kind=kind, n_objects=n, capacity=cap, capacity_bytes=cap_bytes, max_victims=max_victims,
              **KNOBS.get(kind, {}))
    return torch_cache.PolicySpec(**kw), jax_cache.PolicySpec(**kw)


def _assert_state_equal(port_state, ref_state):
    ref = {k: np.asarray(v) for k, v in ref_state.items()}
    assert set(port_state) == set(ref)
    for k, v in port_state.items():
        assert v.numpy().dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("dist", workloads.SIZE_DISTS)
@pytest.mark.parametrize("kind", BYTE_KINDS)
def test_byte_mode_matches_jax(kind, dist):
    sizes = _sizes(dist)
    port_spec, ref_spec = _specs(kind, int(sizes.sum() // 6))
    traces = _traces(2, T, seed=29)
    hits, state = torch_cache.simulate_batch(port_spec, traces, sizes=sizes, device="cpu")
    for i in range(2):
        ref_hits, ref_state = jax_cache.simulate(ref_spec, jnp.asarray(traces[i]), None, jnp.asarray(sizes))
        np.testing.assert_array_equal(hits[i].numpy(), np.asarray(ref_hits))
        _assert_state_equal({k: v[i] for k, v in state.items()}, ref_state)
        evictions = torch_cache.eviction_count(port_spec, hits[i], traces[i], {k: v[i] for k, v in state.items()})
        assert evictions == jax_cache.eviction_count(ref_spec, ref_hits, traces[i], ref_state)
    assert int(state["bytes"].max()) <= port_spec.capacity_bytes


@pytest.mark.parametrize("kind", BYTE_KINDS)
def test_step_traced_budget_fill_gate_and_ledger_match_jax(kind):
    """Per-sample budgets and a fill gate against the reference step vmapped
    over samples; after every step the ledger equals the resident bytes and
    stays within the sample's budget."""
    sizes = _sizes("pareto", seed=5)
    s, t = 3, 300
    port_spec, ref_spec = _specs(kind, 100, max_victims=3)
    traces = _traces(s, t, seed=13)
    fills = np.random.default_rng(2).random((s, t)) < 0.7
    budgets = np.array([40, 100, 250], np.int32)
    sizes_j = jnp.asarray(sizes)

    def ref_run(trace, fill, cap_b):
        return jax.lax.scan(
            lambda st, xf: jax_cache.step(ref_spec, st, xf[0], fill=xf[1], sizes=sizes_j, cap_bytes=cap_b),
            jax_cache.init_state(ref_spec), (trace, fill))

    ref_state, ref_hits = jax.vmap(ref_run)(jnp.asarray(traces), jnp.asarray(fills), jnp.asarray(budgets))
    state = torch_cache.init_state(port_spec, n_samples=s, device="cpu")
    sizes_t = torch.as_tensor(sizes)
    hits = []
    for i in range(t):
        state, hit = torch_cache.step(port_spec, state, torch.as_tensor(traces[:, i]),
                                      fill=torch.as_tensor(fills[:, i]), sizes=sizes_t,
                                      cap_bytes=torch.as_tensor(budgets))
        hits.append(hit.clone())
        resident = (state["in_cache"].long() * sizes_t).sum(dim=1)
        assert torch.equal(resident, state["bytes"].long()) and bool((resident <= torch.as_tensor(budgets)).all())
    np.testing.assert_array_equal(torch.stack(hits, dim=1).numpy(), np.asarray(ref_hits))
    _assert_state_equal(state, ref_state)


@pytest.mark.parametrize("kind", ["lfu", "gdsf", "plfua_dyn", "tinylfu"])
def test_byte_state_handed_over_mid_trace(kind):
    sizes = _sizes()
    port_spec, ref_spec = _specs(kind, int(sizes.sum() // 6))
    trace = _traces(1, 600, seed=31)[0]
    half = 300  # a refresh boundary for plfua_dyn (2 x 150)
    sizes_j = jnp.asarray(sizes)
    first_hits, mid = jax_cache.simulate(ref_spec, jnp.asarray(trace[:half]), None, sizes_j)
    carried = torch_cache.state_from_numpy(port_spec, {k: np.asarray(v) for k, v in mid.items()}, device="cpu")
    rest_hits, state = torch_cache.simulate(port_spec, trace[half:], sizes=sizes, state=carried, device="cpu")
    ref_hits, ref_state = jax_cache.simulate(ref_spec, jnp.asarray(trace), None, sizes_j)
    np.testing.assert_array_equal(np.concatenate([np.asarray(first_hits), rest_hits.numpy()]),
                                  np.asarray(ref_hits))
    _assert_state_equal(state, ref_state)


def _run_steps(spec, trace, sizes):
    state = torch_cache.init_state(spec, n_samples=1, device="cpu")
    counts = []
    for x in trace:
        before = int(state["count"][0])
        state, _ = torch_cache.step(spec, state, torch.tensor([x]), sizes=torch.as_tensor(sizes))
        counts.append((before, int(state["count"][0])))
    return state, counts


@pytest.mark.parametrize("kind", ["lfu", "lru", "gdsf", "plfua_dyn"])
def test_max_victims_abandons_and_an_oversized_object_evicts_nothing(kind):
    """An object needing more victims than ``max_victims`` allows is not
    inserted after exactly that many evictions; one larger than the whole
    budget evicts nothing. Both as the reference step."""
    sizes = np.full(N, 4, np.int32)
    sizes[0] = 40  # needs 10 victims of 4 bytes; the loop grants 2
    trace = np.array(list(range(1, 13)) + [0], np.int32)
    kw = dict(hot_size=N) if kind == "plfua_dyn" else {}
    port_spec = torch_cache.PolicySpec(kind, N, CAP, capacity_bytes=48, max_victims=2, **kw)
    ref_spec = jax_cache.PolicySpec(kind, N, CAP, capacity_bytes=48, max_victims=2, **kw)
    state, counts = _run_steps(port_spec, trace, sizes)
    assert counts[-1] == (12, 10) and not bool(state["in_cache"][0, 0]) and int(state["bytes"][0]) == 40
    _, ref_state = jax_cache.simulate(ref_spec, jnp.asarray(trace), None, jnp.asarray(sizes))
    _assert_state_equal({k: v[0] for k, v in state.items()}, ref_state)
    sizes[0] = 100  # larger than the budget
    state, counts = _run_steps(port_spec, trace, sizes)
    assert counts[-1] == (12, 12) and int(state["bytes"][0]) == 48
    _, ref_state = jax_cache.simulate(ref_spec, jnp.asarray(trace), None, jnp.asarray(sizes))
    _assert_state_equal({k: v[0] for k, v in state.items()}, ref_state)


def test_multi_victim_eviction_fires():
    """The catalogue and budget of these tests evict two or more residents
    for one insertion somewhere, so the loop itself is under test."""
    sizes = _sizes()
    spec, _ = _specs("lfu", int(sizes.sum() // 6))
    _, counts = _run_steps(spec, _traces(1, T, seed=29)[0], sizes)
    assert max(before + 1 - after for before, after in counts) >= 2


@pytest.mark.parametrize("kind", BYTE_KINDS)
def test_unit_sizes_degenerate_to_object_mode(kind):
    """sizes = 1 and capacity_bytes == capacity give object-count mode's hits
    and state; the ledger equals the count."""
    traces = _traces(2, 400, seed=31)
    obj_spec, _ = _specs(kind, 0)
    byte_spec, _ = _specs(kind, CAP)
    h0, s0 = torch_cache.simulate_batch(obj_spec, traces, device="cpu")
    h1, s1 = torch_cache.simulate_batch(byte_spec, traces, sizes=np.ones(N, np.int32), device="cpu")
    assert torch.equal(h0, h1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert torch.equal(s1["bytes"], s1["count"])


@pytest.mark.parametrize("dist", workloads.SIZE_DISTS)
@pytest.mark.parametrize("kind", ref_cache_sim.BYTE_CAPABLE_KINDS)
def test_ops_byte_mode_matches_reference_kernel(kind, dist):
    sizes = _sizes(dist, seed=7)
    cap_b = int(sizes.sum() // 5)
    traces = _traces(2, 300, seed=11)
    kw = dict(kind=kind, n_objects=N, capacity=CAP, capacity_bytes=cap_b, **KNOBS.get(kind, {}))
    ref = ref_ops.cache_sim(traces, sizes=jnp.asarray(sizes), interpret=True, **kw)
    port = ops.cache_sim(traces, sizes=sizes, device="cpu", **kw)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the fourth output is the reference simulator's insert count
    inserts = ops.cache_sim_outputs(traces, sizes=sizes, device="cpu", **kw)["inserts"]
    spec = jax_cache.PolicySpec(**{k: v for k, v in kw.items()})
    for i in range(2):
        _, state = jax_cache.simulate(spec, jnp.asarray(traces[i]), None, jnp.asarray(sizes))
        assert int(inserts[i]) == int(state["inserts"])


@pytest.mark.parametrize("kind", ref_cache_sim.BYTE_CAPABLE_KINDS)
def test_ops_unit_sizes_degenerate_to_object_mode(kind):
    traces = _traces(2, 300, seed=7)
    kw = dict(kind=kind, n_objects=N, capacity=CAP, device="cpu", **KNOBS.get(kind, {}))
    for a, b in zip(ops.cache_sim(traces, **kw), ops.cache_sim(traces, capacity_bytes=CAP, **kw)):
        assert torch.equal(a, b), kind


@pytest.mark.parametrize("dist", workloads.SIZE_DISTS)
def test_ops_gdsf_sized_object_mode_matches_reference_kernel(dist):
    sizes = _sizes(dist, seed=9)
    traces = _traces(2, 400, seed=17)
    ref = ref_ops.cache_sim(traces, kind="gdsf", n_objects=N, capacity=CAP, sizes=jnp.asarray(sizes),
                            interpret=True)
    port = ops.cache_sim(traces, kind="gdsf", n_objects=N, capacity=CAP, sizes=sizes, device="cpu")
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ops_hit_bytes_are_the_bytes_of_the_hits():
    sizes = _sizes("pareto")
    traces = _traces(2, 300, seed=19)
    kw = dict(kind="gdsf", n_objects=N, capacity=CAP, capacity_bytes=int(sizes.sum() // 6))
    outs = ops.cache_sim_outputs(traces, sizes=sizes, device="cpu", **kw)
    spec = jax_cache.PolicySpec(**kw)
    for i in range(2):
        hits, _ = jax_cache.simulate(spec, jnp.asarray(traces[i]), None, jnp.asarray(sizes))
        assert int(outs["hit_bytes"][i]) == int(sizes[traces[i]][np.asarray(hits)].sum())


def test_byte_kernel_kinds_follow_the_reference():
    assert port_kernel.BYTE_CAPABLE_KINDS == ref_cache_sim.BYTE_CAPABLE_KINDS
    with pytest.raises(ValueError, match="byte-capacity"):
        torch_cache.PolicySpec("arc", N, CAP, capacity_bytes=64)
