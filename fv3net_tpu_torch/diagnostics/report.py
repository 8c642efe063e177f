"""HTML report generation (a copy of the JAX package's
``diagnostics/report.py``; external/report/report/create_report.py
equivalent, dependency-free: inline SVG sparkline plots instead of
matplotlib/holoviews figures).  Host numpy; ``generate_run_report``
computes the prognostic-run diagnostics first, their pressure-level
interpolation on a torch device (``diagnostics/compute.py``)."""

from __future__ import annotations

import datetime
import html
import os
from typing import Dict, Mapping, Sequence

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: sans-serif; margin: 2em; }}
h1 {{ border-bottom: 2px solid #333; }}
table {{ border-collapse: collapse; margin: 1em 0; }}
td, th {{ border: 1px solid #999; padding: 4px 10px; }}
.metadata {{ color: #666; font-size: 0.9em; }}
section {{ margin-bottom: 2em; }}
</style></head>
<body>
<h1>{title}</h1>
<p class="metadata">created {created}{metadata}</p>
{body}
</body></html>
"""


def _svg_line(y: np.ndarray, width=480, height=120) -> str:
    y = np.asarray(y, float).ravel()
    y = y[np.isfinite(y)]
    if y.size < 2:
        return "<em>(no data)</em>"
    x = np.linspace(0, width, y.size)
    lo, hi = float(y.min()), float(y.max())
    span = (hi - lo) or 1.0
    ys = height - (y - lo) / span * (height - 10) - 5
    pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(x, ys))
    return (
        f'<svg width="{width}" height="{height}" '
        f'style="background:#f8f8f8">'
        f'<polyline fill="none" stroke="#1f77b4" stroke-width="1.5" '
        f'points="{pts}"/>'
        f'<text x="4" y="12" font-size="10">max {hi:.4g}</text>'
        f'<text x="4" y="{height - 4}" font-size="10">min {lo:.4g}'
        f"</text></svg>"
    )


class HTMLReport:
    def __init__(self, title: str, metadata: Mapping = None):
        self.title = title
        self.metadata = dict(metadata or {})
        self.sections: Dict[str, list] = {}

    def add_timeseries(self, section: str, name: str, values):
        self.sections.setdefault(section, []).append(
            f"<h3>{html.escape(name)}</h3>{_svg_line(values)}"
        )

    def add_table(self, section: str, name: str,
                  rows: Mapping[str, object]):
        body = "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td>{html.escape(f'{v:.6g}' if isinstance(v, float) else str(v))}"
            f"</td></tr>"
            for k, v in rows.items()
        )
        self.sections.setdefault(section, []).append(
            f"<h3>{html.escape(name)}</h3>"
            f"<table><tr><th>metric</th><th>value</th></tr>{body}</table>"
        )

    def render(self) -> str:
        body = ""
        for section, items in self.sections.items():
            body += (
                f"<section><h2>{html.escape(section)}</h2>"
                + "".join(items)
                + "</section>"
            )
        metadata = "".join(
            f" | {html.escape(str(k))}: {html.escape(str(v))}"
            for k, v in self.metadata.items()
        )
        return _PAGE.format(
            title=html.escape(self.title),
            created=datetime.datetime.now().isoformat(timespec="seconds"),
            metadata=metadata,
            body=body,
        )


def create_html(
    sections: Mapping[str, Sequence[str]],
    title: str,
    metadata: Mapping = None,
) -> str:
    """(report/create_report.py create_html): sections of raw HTML."""
    report = HTMLReport(title, metadata)
    for name, items in sections.items():
        report.sections[name] = list(items)
    return report.render()


def write_report(report: HTMLReport, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(report.render())


def generate_run_report(run_path: str, area, output_path: str,
                        title="prognostic run report", device=None):
    """compute + report in one call (the `prognostic_run_diags report`
    path, views/static_report.py equivalent); the diagnostics'
    interpolation on `device` (None: the CUDA device)."""
    from .compute import compute_diagnostics

    diags, metrics = compute_diagnostics(run_path, area, device=device)
    rep = HTMLReport(title, {"run": run_path})
    for name, val in diags.items():
        arr = np.asarray(val)
        if arr.ndim == 1:
            rep.add_timeseries("Timeseries", name, arr)
    rep.add_table("Metrics", "scalar metrics", metrics)
    write_report(rep, output_path)
    return output_path
