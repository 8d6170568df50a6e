"""Named request-trace scenarios: the port's copy of the reference's six host
generators, the tenant catalogue and the size catalogue.

``SCENARIOS`` maps a name to a generator and ``make_traces`` builds
``(n_samples, trace_len)`` int32 traces of ids in ``[0, n_objects)`` for it,
ready for ``torch_cache`` and the cache_sim kernel:

    from repro_torch import workloads
    traces = workloads.make_traces("multi_tenant", n_objects=2000, n_samples=4,
                                   trace_len=20_000, seed=1)
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from repro_torch.core import zipf
from repro_torch.workloads.generators import (
    SIZE_DISTS,
    churn,
    diurnal,
    flash_crowd,
    multi_tenant,
    object_sizes,
    scan,
    stationary,
    tenant_groups,
)

__all__ = [
    "SCENARIOS",
    "SCENARIO_NAMES",
    "SIZE_DISTS",
    "make_traces",
    "stationary",
    "churn",
    "flash_crowd",
    "diurnal",
    "multi_tenant",
    "scan",
    "tenant_groups",
    "object_sizes",
]

SCENARIOS: dict[str, Callable[..., np.ndarray]] = {
    "stationary": stationary,
    "churn": churn,
    "flash_crowd": flash_crowd,
    "diurnal": diurnal,
    "multi_tenant": multi_tenant,
    "scan": scan,
}

SCENARIO_NAMES = tuple(SCENARIOS)


def make_traces(
    scenario: str,
    n_objects: int,
    n_samples: int = zipf.PAPER_NUM_SAMPLES,
    trace_len: int = zipf.PAPER_TRACE_LEN,
    seed: int = 0,
    **overrides: Any,
) -> np.ndarray:
    """Build ``(n_samples, trace_len)`` int32 traces for a named scenario."""
    try:
        fn = SCENARIOS[scenario]
    except KeyError:
        raise ValueError(f"unknown scenario {scenario!r}; expected one of {SCENARIO_NAMES}") from None
    out = np.asarray(fn(n_objects, n_samples, trace_len, seed=seed, **overrides), np.int32)
    if out.shape != (n_samples, trace_len):
        raise AssertionError(f"{scenario}: generator emitted shape {out.shape}, expected {(n_samples, trace_len)}")
    return out
