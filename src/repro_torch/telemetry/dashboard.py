"""Self-contained static HTML operator dashboard.

The port's copy of the reference package's dashboard. Renders the
per-(node, window, group) rows that ``FleetReport.window_rows``
/ :func:`repro_torch.telemetry.export.series_rows` already produce (and the JSONL
artifacts round-trip) into one HTML file: windowed CHR / occupancy /
latency sparklines per tenant per tier plus an optional per-tenant SLO
summary table. Everything is inline — hand-built markup, inline CSS and
inline ``<svg>`` polylines, **no scripts, no external assets** — so the page
opens anywhere, including file:// sandboxes.
"""
from __future__ import annotations

import html
from collections import defaultdict

__all__ = ["render_dashboard", "sparkline", "write_dashboard"]

_CSS = """
body { font-family: ui-monospace, Menlo, Consolas, monospace; margin: 1.5rem;
       background: #111418; color: #d8dee4; }
h1 { font-size: 1.2rem; } h2 { font-size: 1.0rem; margin-top: 1.6rem; }
table { border-collapse: collapse; margin-top: .6rem; }
th, td { border: 1px solid #2c313a; padding: .25rem .55rem;
         font-size: .78rem; text-align: right; }
th { background: #1b2027; } td.k, th.k { text-align: left; }
.spark { display: inline-block; margin: 0 1rem .4rem 0; }
.spark .lbl { font-size: .72rem; color: #8b949e; }
.spark .val { color: #d8dee4; }
svg { background: #1b2027; border: 1px solid #2c313a; }
"""


def sparkline(values, *, width=220, height=36, color="#58a6ff") -> str:
    """One inline-SVG polyline over ``values`` (min/max normalised; a flat
    or empty series draws a midline)."""
    vals = [float(v) for v in values]
    if not vals:
        vals = [0.0]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    n = len(vals)
    pts = []
    for i, v in enumerate(vals):
        x = 2 + (width - 4) * (i / max(1, n - 1))
        y = 2 + (height - 4) * (1.0 - (v - lo) / span)
        pts.append(f"{x:.1f},{y:.1f}")
    return (
        f'<svg width="{width}" height="{height}" viewBox="0 0 {width} {height}">'
        f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
        f'points="{" ".join(pts)}" /></svg>'
    )


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _spark_block(label: str, values, *, color="#58a6ff") -> str:
    last = _fmt(values[-1]) if len(values) else "-"
    return (
        '<div class="spark"><div class="lbl">'
        f"{html.escape(label)} · last <span class=\"val\">{html.escape(last)}</span>"
        f"</div>{sparkline(values, color=color)}</div>"
    )


def _table(rows: list[dict]) -> str:
    if not rows:
        return ""
    cols: dict[str, None] = {}
    for r in rows:
        for k in r:
            cols.setdefault(k)
    head = "".join(
        f'<th class="k">{html.escape(c)}</th>' if i == 0 else f"<th>{html.escape(c)}</th>"
        for i, c in enumerate(cols)
    )
    body = []
    for r in rows:
        cells = []
        for i, c in enumerate(cols):
            cls = ' class="k"' if i == 0 else ""
            cells.append(f"<td{cls}>{html.escape(_fmt(r.get(c, '')))}</td>")
        body.append("<tr>" + "".join(cells) + "</tr>")
    return f"<table><tr>{head}</tr>{''.join(body)}</table>"


def render_dashboard(
    rows: list[dict],
    *,
    latency=None,
    tenant_rows: list[dict] | None = None,
    title: str = "Cache fleet — tenant dashboard",
) -> str:
    """Render grouped per-window rows into one self-contained HTML page.

    ``rows`` are the grouped ``window_rows()`` dicts (must carry ``window``
    and the metric columns; ``level`` and ``group`` default to single
    buckets when absent, so flat ungrouped exports render too). ``latency``
    is an optional :class:`repro_torch.telemetry.latency.LatencyModel` — levels
    are taken in first-seen row order (edge first, the ``window_rows``
    order) and a per-tenant mean-latency-per-window sparkline is derived
    from the per-level serve counts. ``tenant_rows`` (e.g.
    ``FleetReport.tenant_rows()``) renders as the SLO summary table.
    """
    levels: list = []
    acc: dict = defaultdict(lambda: defaultdict(lambda: defaultdict(float)))
    groups: set = set()
    for r in rows:
        lvl = r.get("level", r.get("node", "cache"))
        if lvl not in levels:
            levels.append(lvl)
        g = r.get("group", 0)
        groups.add(g)
        w = int(r["window"])
        cell = acc[(lvl, g)][w]
        for k in ("requests", "hits", "occupancy", "hit_bytes", "miss_bytes"):
            cell[k] += float(r.get(k, 0))
    group_list = sorted(groups, key=str)
    windows = sorted({w for by_w in acc.values() for w in by_w})

    def per_window(lvl, g, key):
        return [acc[(lvl, g)][w][key] for w in windows]

    parts = [
        "<!doctype html><html><head><meta charset=\"utf-8\">",
        f"<title>{html.escape(title)}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{html.escape(title)}</h1>",
        f"<p>{len(levels)} tier(s) · {len(group_list)} tenant(s) · "
        f"{len(windows)} window(s)</p>",
    ]
    if tenant_rows:
        parts.append("<h2>Per-tenant SLO summary</h2>")
        parts.append(_table(tenant_rows))
    for lvl in levels:
        parts.append(f"<h2>tier {html.escape(str(lvl))}</h2>")
        for g in group_list:
            req = per_window(lvl, g, "requests")
            hit = per_window(lvl, g, "hits")
            chr_w = [h / r if r else 0.0 for h, r in zip(hit, req)]
            occ = per_window(lvl, g, "occupancy")
            parts.append(f"<div><b>tenant {html.escape(str(g))}</b><br>")
            parts.append(_spark_block("chr", chr_w))
            parts.append(_spark_block("occupancy", occ, color="#d29922"))
            parts.append("</div>")
    if latency is not None and levels:
        parts.append("<h2>Per-tenant latency (mean µs per window)</h2>")
        edge = levels[0]
        for g in group_list:
            req = per_window(edge, g, "requests")
            lat = []
            for wi, w in enumerate(windows):
                served = [acc[(lvl, g)][w]["hits"] for lvl in levels[: latency.n_levels]]
                served += [0.0] * (latency.n_levels - len(served))
                origin = max(0.0, req[wi] - sum(served))
                lat.append(latency.mean_us(served + [origin]))
            parts.append(f"<div><b>tenant {html.escape(str(g))}</b><br>")
            parts.append(_spark_block("mean_us", lat, color="#3fb950"))
            parts.append("</div>")
    parts.append("</body></html>")
    return "".join(parts)


def write_dashboard(path, rows, **kwargs) -> str:
    """Render and write the dashboard; returns the path."""
    html_text = render_dashboard(rows, **kwargs)
    with open(path, "w") as fh:
        fh.write(html_text)
    return str(path)
