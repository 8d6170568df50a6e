"""ARC in the port against the reference, on the CPU.

``ops.cache_sim(kind="arc", device="cpu")`` must equal the reference kernel
in interpret mode exactly (hits, the stamps it returns in ``freq``, ghosts
included, and in_cache) on Zipf and ``scan`` traces, and report the
reference simulator's directory size. ``torch_cache``'s step must keep ARC's
invariants after every request, with and without the fill gate, and take the
gate's three paths (park skipped, an unfilled ghost hit refreshed in place,
an unfilled cold miss parked in B1) as the reference step does. On the scan
workload arc must beat lru and lfu by the margin ``tests/test_arc.py`` pins,
with the reference's CHRs to the last request. Everything compared is an
integer or a bool, so the tolerance is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads
from repro.core import jax_cache
from repro.kernels.cache_sim import ops as ref_ops
from repro_torch.core import torch_cache
from repro_torch.kernels.cache_sim import ops

SCAN_KW = dict(n_sweeps=6, sweep_len_frac=0.06)


@pytest.mark.parametrize("scenario", ["stationary", "scan"])
@pytest.mark.parametrize("n,cap,s,t", [(64, 9, 3, 400), (130, 3, 2, 500), (16, 1, 2, 300), (300, 30, 2, 800)])
def test_ops_arc_matches_reference_kernel(scenario, n, cap, s, t):
    traces = workloads.make_traces(scenario, n, n_samples=s, trace_len=t, seed=33,
                                   **(SCAN_KW if scenario == "scan" else {}))
    ref = ref_ops.cache_sim(traces, kind="arc", n_objects=n, capacity=cap, interpret=True)
    outs = ops.cache_sim_outputs(traces, kind="arc", n_objects=n, capacity=cap, device="cpu")
    for name, want in zip(("hits", "freq", "in_cache"), ref):
        np.testing.assert_array_equal(outs[name].numpy(), np.asarray(want), err_msg=name)
    spec = jax_cache.PolicySpec("arc", n, cap)
    for i in range(s):
        _, state = jax_cache.simulate(spec, jnp.asarray(traces[i]))
        assert int(outs["dir_size"][i]) == int(jax_cache.metadata_entries(spec, state))


def _list_sizes(state):
    lst = state["lst"]
    return [(lst == tag).sum(dim=1) for tag in (torch_cache.T1, torch_cache.T2, torch_cache.B1, torch_cache.B2)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("cap", [1, 3, 7])
def test_arc_invariants_every_step(cap, gated):
    n, s, t = 40, 3, 400
    rng = np.random.default_rng(cap)
    head = rng.integers(0, n // 4, (s, t))
    traces = np.where(rng.random((s, t)) < 0.5, head, rng.integers(0, n, (s, t))).astype(np.int32)
    fills = rng.random((s, t)) < 0.5 if gated else np.ones((s, t), bool)
    spec = torch_cache.PolicySpec("arc", n, cap)
    state = torch_cache.init_state(spec, n_samples=s, device="cpu")
    for i in range(t):
        p_before, lx = state["p"].clone(), state["lst"][torch.arange(s), torch.as_tensor(traces[:, i]).long()]
        state, _ = torch_cache.step(spec, state, torch.as_tensor(traces[:, i]), fill=torch.as_tensor(fills[:, i]))
        t1, t2, b1, b2 = _list_sizes(state)
        assert bool(((t1 + t2 <= cap) & (t1 + b1 <= cap) & (t1 + t2 + b1 + b2 <= 2 * cap)).all())
        assert bool(((state["p"] >= 0) & (state["p"] <= cap)).all())
        assert torch.equal(state["in_cache"], (state["lst"] == 1) | (state["lst"] == 2))
        # only a ghost hit moves p: B1 up, B2 down
        p = state["p"]
        assert bool((p[lx == torch_cache.B1] >= p_before[lx == torch_cache.B1]).all())
        assert bool((p[lx == torch_cache.B2] <= p_before[lx == torch_cache.B2]).all())
        assert torch.equal(p[lx <= torch_cache.T2], p_before[lx <= torch_cache.T2])


def test_arc_fill_gate_paths_match_jax():
    """A gated run takes all three unfilled paths, step for step as the
    reference's: the skipped park, the in-place ghost refresh, the cold park."""
    n, cap, s, t = 30, 4, 4, 600
    rng = np.random.default_rng(21)
    traces = rng.integers(0, n, (s, t)).astype(np.int32)
    fills = rng.random((s, t)) < 0.6
    spec = torch_cache.PolicySpec("arc", n, cap)
    ref_spec = jax_cache.PolicySpec("arc", n, cap)
    state = torch_cache.init_state(spec, n_samples=s, device="cpu")
    seen = dict(park_skip=0, ghost_refresh=0, cold_park=0)
    rows = torch.arange(s)
    for i in range(t):
        x, fill = torch.as_tensor(traces[:, i]).long(), torch.as_tensor(fills[:, i])
        lx = state["lst"][rows, x]
        t1, _, b1, _ = _list_sizes(state)
        cold_unfilled = (lx == 0) & ~fill
        skip = cold_unfilled & (t1 + b1 >= cap) & (b1 == 0)
        seen["park_skip"] += int(skip.sum())
        seen["cold_park"] += int((cold_unfilled & ~skip).sum())
        seen["ghost_refresh"] += int(((lx >= torch_cache.B1) & ~fill).sum())
        state, _ = torch_cache.step(spec, state, x, fill=fill)
    assert min(seen.values()) > 0, seen

    def ref_run(trace, fill):
        return jax.lax.scan(lambda st, xf: jax_cache.step(ref_spec, st, xf[0], fill=xf[1]),
                            jax_cache.init_state(ref_spec), (trace, fill))

    ref_state, _ = jax.vmap(ref_run)(jnp.asarray(traces), jnp.asarray(fills))
    for k, v in ref_state.items():
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(v), err_msg=k)


def test_scan_resistance_matches_reference():
    """tests/test_arc.py's setting (n = 600, cap = 30, 3 x 12,000 requests,
    seed 33, 6 sweeps of 6 %): the port's CHRs equal the reference's, and arc
    beats lru and lfu by at least 0.05."""
    n, cap, s, t = 600, 30, 3, 12_000
    traces = workloads.make_traces("scan", n, n_samples=s, trace_len=t, seed=33, **SCAN_KW)
    chrs = {}
    for kind in ("lru", "lfu", "arc"):
        hits = ops.cache_sim(traces, kind=kind, n_objects=n, capacity=cap, device="cpu")[0]
        ref = jax_cache.simulate_batch(jax_cache.PolicySpec(kind, n, cap), jnp.asarray(traces))
        np.testing.assert_array_equal(hits.numpy(), np.asarray(ref).sum(axis=1))
        chrs[kind] = float(hits.sum()) / (s * t)
    assert chrs["arc"] >= chrs["lru"] + 0.05 and chrs["arc"] >= chrs["lfu"] + 0.05, chrs


def test_arc_byte_mode_raises():
    traces = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="byte-capacity mode is not supported"):
        ops.cache_sim(traces, kind="arc", n_objects=16, capacity=4, capacity_bytes=64, device="cpu")
    with pytest.raises(ValueError, match="arc does not support byte-capacity mode"):
        torch_cache.PolicySpec("arc", 16, 4, capacity_bytes=64)


def _arc_by_list_heads(trace, n, cap):
    """ARC as the card runs it: one insertion-ordered list per tag, each step's victims named
    by list head (an empty list names id 0, which a retag then moves from wherever it sits).
    Checks at every head lookup that the head is the list's least-stamped id with ties to the
    lowest, the reference's ``victim_of(stamp, lst == L)``. Returns (hits per step, tags,
    stamps, p)."""
    lists = {tag: {} for tag in (torch_cache.T1, torch_cache.T2, torch_cache.B1, torch_cache.B2)}
    tag, stamp, p, hits = [0] * n, [0] * n, 0, []

    def head(lst):
        if not lists[lst]:
            return 0
        h = next(iter(lists[lst]))
        assert h == min(lists[lst], key=lambda i: (stamp[i], i))
        return h

    def retag(i, new):
        lists.get(tag[i], {}).pop(i, None)
        if new:
            lists[new][i] = None
        tag[i] = new

    for t, x in enumerate(trace.tolist()):
        lx = tag[x]
        n1, n2, n3, n4 = (len(lists[k]) for k in (torch_cache.T1, torch_cache.T2, torch_cache.B1, torch_cache.B2))
        hit, g2 = lx in (torch_cache.T1, torch_cache.T2), lx == torch_cache.B2
        ghost, cold = lx in (torch_cache.B1, torch_cache.B2), lx == 0
        if lx == torch_cache.B1:
            p = min(cap, p + max(1, n4 // max(1, n3)))
        elif g2:
            p = max(0, p - max(1, n3 // max(1, n4)))
        case_a = cold and n1 + n3 >= cap
        hard_t1 = case_a and n3 == 0
        if case_a and n3 > 0:
            retag(head(torch_cache.B1), 0)
        elif cold and not case_a and n1 + n2 + n3 + n4 >= 2 * cap and n4 > 0:
            retag(head(torch_cache.B2), 0)
        need_evict = not hit and not hard_t1 and n1 + n2 >= cap
        from_t1 = n1 >= 1 and ((g2 and n1 == p) or n1 > p or n2 == 0)
        if need_evict or hard_t1:
            victim = head(torch_cache.T1 if hard_t1 or from_t1 else torch_cache.T2)
            retag(victim, 0 if hard_t1 else torch_cache.B1 if from_t1 else torch_cache.B2)
            if need_evict:
                stamp[victim] = t
        retag(x, torch_cache.T2 if hit or ghost else torch_cache.T1)
        stamp[x] = t
        hits.append(hit)
    return hits, tag, stamp, p


@pytest.mark.parametrize("cap", [-3, 0, 1, 3, 9])
@pytest.mark.parametrize("trace", ["zipf", "scan", "cyclic"])
def test_list_heads_name_the_reference_victims(trace, cap):
    """A list's LRU (least stamp, ties to the lowest id) is its head: every write that puts
    an id into a list stamps it with the step, and a step puts at most one id into each list.
    The list model equals ``torch_cache`` step for step (hits), and in its final tags, stamps
    and p, at capacities <= 0 too (where an empty list's id 0 moves between lists)."""
    n, s, t = 40, 2, 600
    if trace == "cyclic":
        traces = np.stack([(np.arange(t) + 3 * i) % n for i in range(s)]).astype(np.int32)
    else:
        traces = workloads.make_traces("scan" if trace == "scan" else "stationary", n, n_samples=s, trace_len=t,
                                       seed=8, **(dict(n_sweeps=3, sweep_len_frac=0.2) if trace == "scan" else {}))
    spec = torch_cache.PolicySpec("arc", n, cap)
    hits, state = torch_cache.simulate_batch(spec, torch.as_tensor(traces), device="cpu")
    for i in range(s):
        model_hits, tags, stamps, p = _arc_by_list_heads(traces[i], n, cap)
        assert hits[i].tolist() == model_hits
        assert state["lst"][i].tolist() == tags and state["stamp"][i].tolist() == stamps
        assert int(state["p"][i]) == p
    assert trace == "cyclic" or int(hits.sum()) > 0  # a cycle over all 40 ids never hits
