"""Windowed telemetry and measurement on the card.

* :mod:`repro_torch.telemetry.spec` — :class:`TelemetrySpec` and the window
  bucketing of per-step events into the 11-metric series (ungrouped or per
  tenant group), the port's copy of the reference's, on torch tensors.
* :mod:`repro_torch.telemetry.timing` — CUDA-event timing with the
  first-call/execute split and an optional ``torch.profiler`` trace.
"""
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

__all__ = [
    "METRIC_INDEX",
    "METRICS",
    "N_METRICS",
    "TelemetrySpec",
    "bucket_end",
    "bucket_sum",
    "chunk_window_matrix",
    "group_onehot",
    "grouped_series_from_run",
    "n_windows",
    "series_from_run",
    "window_sizes",
    "windowed_pressure",
]
