"""The port's simulator over every kind x every workload scenario.

``tests/test_differential.py`` holds ``jax_cache.simulate`` to the Python
policies over the 9 kinds x 6 scenarios of ``workloads.SCENARIOS``; this file
holds ``torch_cache.simulate_batch`` to ``jax_cache.simulate`` over the same
matrix, at the same shapes and options (N = 64, T = 600, capacities 3 and 9,
wlfu/tinylfu window 48, plfua_dyn refresh 97, sketch width 64), on traces the
port's own copies of the generators make. Hits and every state entry must be
equal: integers, so the tolerance is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import jax_cache
from repro_torch import workloads
from repro_torch.core import torch_cache

N = 64
TRACE_LEN = 600
WINDOW = 48
REFRESH = 97
SKETCH_W = 64
CAPS = (3, 9)
KINDS = ("lru", "lfu", "plfu", "plfua", "wlfu", "tinylfu", "plfua_dyn", "gdsf", "arc")


def _kw(kind):
    return dict(
        window=WINDOW if kind in ("wlfu", "tinylfu") else 0,
        refresh=REFRESH if kind == "plfua_dyn" else 0,
        sketch_width=SKETCH_W if kind in ("tinylfu", "plfua_dyn") else 0,
    )


def test_matrix_is_total():
    assert set(KINDS) == set(jax_cache.JAX_POLICY_KINDS)
    assert len(workloads.SCENARIO_NAMES) == 6


@pytest.mark.parametrize("scenario", workloads.SCENARIO_NAMES)
@pytest.mark.parametrize("kind", KINDS)
def test_port_matches_jax_on_every_scenario(kind, scenario):
    seed = sum(map(ord, kind + scenario))
    cap = CAPS[seed % 2]
    traces = workloads.make_traces(scenario, N, n_samples=2, trace_len=TRACE_LEN, seed=seed)
    port_spec = torch_cache.PolicySpec(kind, N, cap, **_kw(kind))
    ref_spec = jax_cache.PolicySpec(kind, N, cap, **_kw(kind))
    hits, state = torch_cache.simulate_batch(port_spec, traces, device="cpu")
    ref_hits, ref_state = jax.vmap(lambda tr: jax_cache.simulate(ref_spec, tr))(jnp.asarray(traces))
    ctx = f"{kind} x {scenario} cap={cap} seed={seed}"
    np.testing.assert_array_equal(hits.numpy(), np.asarray(ref_hits), err_msg=ctx)
    assert set(state) == set(ref_state), ctx
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_state[k]), err_msg=f"{k}: {ctx}")
