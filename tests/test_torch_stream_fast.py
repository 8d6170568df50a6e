"""The port's fast compact-lane stream and flat streaming chunks against the reference package.

The same host traces go through ``repro.core.jax_cache`` (JAX on the CPU) and
through the port with ``device="cpu"``; every output is an integer or a bool,
so the tolerance is exact:

* the fast path (``StreamConfig(fast=True)``) for every ``FAST_KINDS`` kind
  and sized gdsf equals ``jax_cache.simulate`` on the concatenated chunks,
  hit for hit and state field for state field (the candidate-prefix bound
  and the id-sorted tie-break hold across chunk seams);
* ``torch_cache.run_chunk`` over K chunks equals ``jax_cache.run_chunk`` and
  ``jax_cache.simulate`` for all nine kinds, plfua_dyn at a chunk length
  that does not divide its period, and ``stream_chunked_scan``'s events
  equal the reference's;
* the carries are written in place: ``run_chunk`` returns the state it was
  given, and the fast carry's tensors keep their ``data_ptr``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import workloads as ref_workloads
from repro.core import jax_cache
from repro.fleet import stream as ref_stream
from repro_torch import fleet
from repro_torch.core import torch_cache
from repro_torch.fleet.stream import FAST_KINDS, FleetStream, StreamConfig

N, G, K = 96, 50, 4
T = G * K
ALL_KINDS = ("lru", "lfu", "wlfu", "plfu", "plfua", "plfua_dyn", "tinylfu", "gdsf", "arc")
SIZES = np.random.default_rng(0).integers(1, 9, size=N).astype(np.int32)

_FAST_SPECS = {
    "lru": {}, "lfu": {}, "plfu": {"hot_size": 24}, "plfua": {"hot_size": 24},
    "plfua_dyn": {"hot_size": 24, "refresh": 2 * G}, "gdsf": {}, "tinylfu": {},
}


def _fast_run(kind, trace, *, n=N, cap=13, g_n=G, sizes=None, **kw):
    """The fast stream over the trace's chunks: (hits, final state, stream)."""
    topo = fleet.tree(n_objects=n, widths=(1,), kinds=kind, capacities=cap, **{k: (v,) for k, v in kw.items()})
    fs = FleetStream(StreamConfig(topo=topo, chunk_len=g_n, fast=True), sizes=sizes, device="cpu")
    hits = [fs.push(trace[c: c + g_n])["hit"][0] for c in range(0, len(trace), g_n)]
    return torch.cat(hits).numpy(), fs.states()[0], fs


def _assert_state(want: dict, got: dict, ctx: str):
    assert set(want) == set(got), (ctx, sorted(want), sorted(got))
    for k in want:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, k, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: state[{k}]")


@pytest.mark.parametrize("scenario", ["churn", "stationary"])
@pytest.mark.parametrize("kind", FAST_KINDS)
def test_stream_fast_parity(kind, scenario):
    """The compact working-set engine == the dense reference simulator, hit for hit and field for
    field (plfua_dyn's refresh of 2 chunks exercises the chunk-end refresh)."""
    kw = _FAST_SPECS[kind]
    spec = jax_cache.PolicySpec(kind=kind, n_objects=N, capacity=13, **kw)
    trace = ref_workloads.make_traces(scenario, N, 1, T, seed=7)[0]
    ref_hits, ref_state = jax_cache.simulate(spec, jnp.asarray(trace))
    hits, state, fs = _fast_run(kind, trace, **kw)
    np.testing.assert_array_equal(hits, np.asarray(ref_hits), err_msg=f"fast {kind} hits")
    _assert_state(ref_state, state, f"fast {kind}")
    st = fs.stats()
    assert st.hits == int(np.asarray(ref_hits).sum()) and st.requests == T and st.chunks == K
    assert st.origin_misses == T - st.hits
    assert int(st.tiers[0]["count"][0]) == int(ref_state["count"])
    if "inserts" in ref_state:
        assert int(st.tiers[0]["evictions"][0]) == int(ref_state["inserts"]) - int(ref_state["count"])


def test_stream_fast_sized_gdsf():
    """Size-aware scoring flows through the compact lanes (the sizes are gathered a lane)."""
    spec = jax_cache.PolicySpec(kind="gdsf", n_objects=N, capacity=13)
    trace = ref_workloads.make_traces("stationary", N, 1, T, seed=9)[0]
    ref_hits, ref_state = jax_cache.simulate(spec, jnp.asarray(trace), sizes=SIZES)
    hits, state, _ = _fast_run("gdsf", trace, sizes=SIZES)
    np.testing.assert_array_equal(hits, np.asarray(ref_hits))
    _assert_state(ref_state, state, "sized gdsf")


@pytest.mark.parametrize("kind", ("lru", "lfu", "tinylfu"))
def test_stream_fast_scan_ties(kind):
    """N = 4,096, capacity 256, chunks of 128 on ``scan``: one-touch sweeps leave many residents
    with equal keys, so the candidate prefix and its lowest-id ties are exercised."""
    n, cap, g_n = 4_096, 256, 128
    trace = ref_workloads.make_traces("scan", n, 1, 8 * g_n, seed=1)[0]
    spec = jax_cache.PolicySpec(kind=kind, n_objects=n, capacity=cap)
    ref_hits, ref_state = jax_cache.simulate(spec, jnp.asarray(trace))
    hits, state, _ = _fast_run(kind, trace, n=n, cap=cap, g_n=g_n)
    assert int(ref_state["count"]) == cap, "the cache must fill"
    np.testing.assert_array_equal(hits, np.asarray(ref_hits), err_msg=f"scan {kind} hits")
    _assert_state(ref_state, state, f"scan {kind}")


def test_stream_fast_matches_reference_stream():
    """Each fast chunk's hits equal the reference's own fast stream push."""
    trace = ref_workloads.make_traces("churn", N, 1, T, seed=8)[0]
    ref_topo = __import__("repro").fleet.tree(n_objects=N, widths=(1,), kinds="tinylfu", capacities=13)
    ref = ref_stream.FleetStream(ref_stream.StreamConfig(topo=ref_topo, chunk_len=G, fast=True))
    want = np.concatenate([np.asarray(ref.push(jnp.asarray(trace[c * G:(c + 1) * G]))["hit"][0])
                           for c in range(K)])
    hits, _, _ = _fast_run("tinylfu", trace)
    np.testing.assert_array_equal(hits, want)


def test_stream_fast_carry_stays_in_place():
    """The fast carry's tensors (state, roster, hit count) keep their storage across pushes, and the
    sentinel row stays out of the cache."""
    trace = ref_workloads.make_traces("churn", N, 1, T, seed=7)[0]
    topo = fleet.tree(n_objects=N, widths=(1,), kinds="plfua_dyn", capacities=13, hot_size=(24,), refresh=(2 * G,))
    fs = FleetStream(StreamConfig(topo=topo, chunk_len=G, fast=True), device="cpu")
    engine = fs._engine
    ptrs = lambda: [v.data_ptr() for v in engine.state.values()] + [engine.roster.data_ptr(),
                                                                    engine.hits.data_ptr()]
    first = ptrs()
    for c in range(K):
        fs.push(trace[c * G:(c + 1) * G])
        assert not bool(engine.state["in_cache"][0, N]), c
    assert ptrs() == first


# ------------------------------------------------------- flat streaming chunks
def _kind_kw(kind):
    return dict(window=48) if kind == "wlfu" else dict(refresh=30) if kind == "plfua_dyn" else {}


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_run_chunk_matches_reference(kind):
    """K run_chunk calls == the reference's K donated run_chunk calls == one simulate over the
    concatenation; the port's call steps the state it was given in place and returns it."""
    kw = _kind_kw(kind)
    rs = jax_cache.PolicySpec(kind, N, 13, **kw)
    ps = torch_cache.PolicySpec(kind, N, 13, **kw)
    trace = ref_workloads.make_traces("churn", N, 1, T, seed=3)[0]
    sizes = SIZES if kind == "gdsf" else None
    want_hits, want_state = jax_cache.simulate(rs, jnp.asarray(trace), sizes=sizes)
    ref_state, ref_hits = jax_cache.init_state(rs), []
    state, hits = torch_cache.init_state(ps, device="cpu"), []
    for c in range(K):
        sl = slice(c * G, (c + 1) * G)
        ref_state, h = jax_cache.run_chunk(rs, ref_state, jnp.asarray(trace[sl]), c * G, sizes)
        ref_hits.append(np.asarray(h))
        out, h = torch_cache.run_chunk(ps, state, trace[sl], t0=c * G, sizes=sizes)
        assert out is state
        hits.append(h.numpy())
    np.testing.assert_array_equal(np.concatenate(hits), np.concatenate(ref_hits))
    np.testing.assert_array_equal(np.concatenate(hits), np.asarray(want_hits))
    _assert_state(want_state, state, f"run_chunk {kind}")
    _assert_state(ref_state, state, f"run_chunk {kind} vs reference chunks")


@pytest.mark.parametrize("g_n", [50, 60, 45])
def test_stream_chunked_scan_events(g_n):
    """stream_chunked_scan with telemetry events over chunks of G in {50, 60, 45} (refresh 30:
    sub-chunks of 10, 30 and 15), with an active mask and grouped events, equals the reference's
    chunk for chunk."""
    from repro.telemetry import spec as ref_tspec

    rs = jax_cache.PolicySpec("plfua_dyn", N, 13, refresh=30)
    ps = torch_cache.PolicySpec("plfua_dyn", N, 13, refresh=30)
    n_groups = 3
    groups = np.random.default_rng(1).integers(0, n_groups, size=N).astype(np.int32)
    og = ref_tspec.group_onehot(jnp.asarray(groups), n_groups, jnp)
    gidx = torch_cache._group_index(torch.as_tensor(groups), n_groups)
    trace = ref_workloads.make_traces("churn", N, 1, 4 * g_n, seed=5)[0]
    active = np.random.default_rng(2).random(4 * g_n) < 0.8
    ref_state, state = jax_cache.init_state(rs), torch_cache.init_state(ps, device="cpu")
    for c in range(4):
        sl = slice(c * g_n, (c + 1) * g_n)
        ref_state, ref_hits, ref_ev = jax_cache.stream_chunked_scan(
            rs, ref_state, jnp.asarray(trace[sl]), jnp.asarray(active[sl]), t0=c * g_n, instrument=True,
            sizes=jnp.asarray(SIZES), og=og)
        _, hits, ev = torch_cache.stream_chunked_scan(ps, state, trace[sl], torch.as_tensor(active[sl]),
                                                      t0=c * g_n, instrument=True, sizes=SIZES, gidx=gidx,
                                                      n_groups=n_groups)
        np.testing.assert_array_equal(hits.numpy(), np.asarray(ref_hits), err_msg=f"chunk {c} hits")
        assert set(ev) == set(ref_ev), (sorted(ev), sorted(ref_ev))
        for k in ref_ev:
            np.testing.assert_array_equal(ev[k].numpy(), np.asarray(ref_ev[k]), err_msg=f"chunk {c} {k}")
    _assert_state(ref_state, state, f"stream_chunked_scan G={g_n}")


def test_stream_sub_len_and_refusal():
    spec = torch_cache.PolicySpec("plfua_dyn", N, 13, refresh=30)
    assert [torch_cache.stream_sub_len(spec, g) for g in (50, 60, 45, 7)] == [10, 30, 15, 1]
    assert torch_cache.stream_sub_len(spec, 50) == jax_cache.stream_sub_len(
        jax_cache.PolicySpec("plfua_dyn", N, 13, refresh=30), 50)
    with pytest.raises(ValueError, match="plfua_dyn"):
        torch_cache.stream_chunked_scan(torch_cache.PolicySpec("lru", N, 13),
                                        torch_cache.init_state(torch_cache.PolicySpec("lru", N, 13), device="cpu"),
                                        np.zeros(G, np.int32), t0=0)


def test_step_table_overrides():
    """step(table=, bloom_tab=) with the spec's own rows is the default step; with other rows it
    hashes through them."""
    spec = torch_cache.PolicySpec("tinylfu", N, 13, doorkeeper=64)
    trace = torch.as_tensor(ref_workloads.make_traces("churn", N, 1, 300, seed=4)[0]).long()
    table, bloom = torch_cache._tables(spec, torch.device("cpu"))
    a, b = (torch_cache.init_state(spec, 1, device="cpu") for _ in range(2))
    for x in trace:
        _, ha = torch_cache.step(spec, a, x[None])
        _, hb = torch_cache.step(spec, b, x[None], table=table.clone(), bloom_tab=bloom.clone())
        assert torch.equal(ha, hb)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    c = torch_cache.init_state(spec, 1, device="cpu")
    for x in trace[:50]:
        torch_cache.step(spec, c, x[None], table=torch.flip(table, [0]), bloom_tab=bloom)
    assert not torch.equal(c["sketch"], torch_cache.simulate(spec, trace[:50], device="cpu")[1]["sketch"][None])
