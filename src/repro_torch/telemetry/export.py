"""JSONL / CSV exporters for windowed telemetry series.

The port's copy of the reference package's exporters. One row per (node,
window) with the :data:`repro_torch.telemetry.spec.METRICS` columns spelled
out plus a derived ``chr`` — the operator-dashboard shape (arXiv:2005.11923's
energy-vs-CHR panels). Both formats round-trip: ``read_jsonl`` returns the
dict rows verbatim; CSV stringifies and is for spreadsheet import.
"""
from __future__ import annotations

import csv
import json

import numpy as np

from repro_torch.telemetry.spec import METRICS, N_METRICS


def series_rows(
    series, window: int, *, labels=None, grouped=False, group_labels=None, **tags
) -> list[dict]:
    """Flatten a ``[..., n_windows, N_METRICS]`` series into per-window dicts.

    Leading axes are flattened and enumerated as ``node`` (or named via
    ``labels``); ``tags`` (policy, scenario, level, ...) are copied into
    every row. ``t_start`` is the window's first trace position.

    ``grouped=True`` reads the group-segmented layout
    ``[..., n_windows, n_groups, N_METRICS]`` instead and emits one row per
    (node, window, group) with a ``group`` column (named via
    ``group_labels``) — the shapes are otherwise ambiguous, so the caller
    states which contract the array follows.
    """
    arr = np.asarray(series)
    min_ndim = 3 if grouped else 2
    if arr.ndim < min_ndim or arr.shape[-1] != N_METRICS:
        raise ValueError(
            f"expected [..., n_windows, {N_METRICS}] series"
            + (" with a group axis" if grouped else "")
            + f", got shape {arr.shape}"
        )
    if grouped:
        flat = arr.reshape(-1, arr.shape[-3], arr.shape[-2], N_METRICS)
    else:
        flat = arr.reshape(-1, arr.shape[-2], 1, N_METRICS)
    n_groups = flat.shape[2]
    rows = []
    for node in range(flat.shape[0]):
        for w in range(flat.shape[1]):
            for g in range(n_groups):
                row = dict(tags)
                row["node"] = int(node) if labels is None else labels[node]
                row["window"] = w
                row["t_start"] = w * window
                if grouped:
                    row["group"] = int(g) if group_labels is None else group_labels[g]
                for m, name in enumerate(METRICS):
                    row[name] = int(flat[node, w, g, m])
                row["chr"] = row["hits"] / row["requests"] if row["requests"] else 0.0
                rows.append(row)
    return rows


def write_jsonl(path, rows) -> None:
    with open(path, "w") as fh:
        for row in rows:
            fh.write(json.dumps(row) + "\n")


def read_jsonl(path) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def write_csv(path, rows) -> None:
    with open(path, "w", newline="") as fh:
        if not rows:
            return
        # Ordered union across ALL rows, not rows[0].keys(): mixed-tag row
        # sets (e.g. fleet level rows carrying byte fields next to flat-cache
        # rows without them) used to crash DictWriter on the first row that
        # introduced a new key. First-seen order keeps the common prefix
        # stable; late-appearing columns append, absent cells write empty.
        fieldnames: dict[str, None] = {}
        for row in rows:
            for key in row:
                fieldnames.setdefault(key)
        writer = csv.DictWriter(fh, fieldnames=list(fieldnames), restval="")
        writer.writeheader()
        writer.writerows(rows)


def read_csv(path) -> list[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))
