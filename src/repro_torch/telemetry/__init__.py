"""Windowed telemetry and measurement on the card.

* :mod:`repro_torch.telemetry.spec` — :class:`TelemetrySpec` and the window
  bucketing of per-step events into the 11-metric series (ungrouped or per
  tenant group), the port's copy of the reference's, on torch tensors.
* :mod:`repro_torch.telemetry.timing` — CUDA-event timing with the
  first-call/execute split and an optional ``torch.profiler`` trace, and
  ``j_per_step`` (management J a request from a CPU interval).
* :mod:`repro_torch.telemetry.latency` — the per-tier service-time model that
  turns grouped fleet series into per-tenant p50/p99 latency.
* :mod:`repro_torch.telemetry.export` and :mod:`repro_torch.telemetry.dashboard`
  — JSONL/CSV rows and a static HTML dashboard of the series.

The host-side oracle lives in :mod:`repro_torch.telemetry.oracle`, imported
explicitly (it pulls in the pure-Python policies and the fleet oracle).
"""
from repro_torch.telemetry.latency import LatencyModel, percentile_us
from repro_torch.telemetry.spec import (
    METRIC_INDEX,
    METRICS,
    N_METRICS,
    TelemetrySpec,
    bucket_end,
    bucket_sum,
    chunk_window_matrix,
    group_onehot,
    grouped_series_from_run,
    n_windows,
    series_from_run,
    window_sizes,
    windowed_pressure,
)
from repro_torch.telemetry.timing import Timing, j_per_step, measure

__all__ = [
    "METRIC_INDEX",
    "METRICS",
    "N_METRICS",
    "LatencyModel",
    "TelemetrySpec",
    "Timing",
    "bucket_end",
    "bucket_sum",
    "chunk_window_matrix",
    "group_onehot",
    "grouped_series_from_run",
    "j_per_step",
    "measure",
    "n_windows",
    "percentile_us",
    "series_from_run",
    "window_sizes",
    "windowed_pressure",
]
