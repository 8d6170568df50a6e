"""Named request-trace scenarios: the port's copy of the reference's six host
generators, the tenant catalogue and the size catalogue.

``SCENARIOS`` maps a name to a generator and ``make_traces`` builds
``(n_samples, trace_len)`` int32 traces of ids in ``[0, n_objects)`` for it,
ready for ``torch_cache`` and the cache_sim kernel:

    from repro_torch import workloads
    traces = workloads.make_traces("multi_tenant", n_objects=2000, n_samples=4,
                                   trace_len=20_000, seed=1)

``TraceSpec`` captures a fully resolved scenario (name, shape, seed and
overrides) as a frozen, hashable value, and ``register_scenario`` adds a
generator under a new name.
"""
from __future__ import annotations

import dataclasses
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
    "TraceSpec",
    "make_traces",
    "register_scenario",
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


def register_scenario(name: str, fn: Callable[..., np.ndarray]) -> None:
    """Register a custom generator under ``name`` (same signature contract)."""
    if name in SCENARIOS:
        raise ValueError(f"scenario {name!r} already registered")
    SCENARIOS[name] = fn


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


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A fully resolved workload scenario (hashable)."""

    scenario: str
    n_objects: int
    n_samples: int = zipf.PAPER_NUM_SAMPLES
    trace_len: int = zipf.PAPER_TRACE_LEN
    seed: int = 0
    overrides: tuple[tuple[str, Any], ...] = ()

    def __post_init__(self):
        if self.scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r}; expected one of {SCENARIO_NAMES}")

    def with_overrides(self, **kw: Any) -> "TraceSpec":
        merged = dict(self.overrides)
        merged.update(kw)
        return dataclasses.replace(self, overrides=tuple(sorted(merged.items())))

    def build(self) -> np.ndarray:
        return make_traces(self.scenario, self.n_objects, self.n_samples, self.trace_len, self.seed,
                           **dict(self.overrides))
