"""Diagnostics of the port (the JAX package's ``diagnostics/``): the
prognostic-run diagnostics (``compute`` with its ``registry``, the
scalar ``metrics`` and the input ``transforms``; host numpy but the
pressure-level interpolation, which runs on a torch device), the offline
evaluation of a trained model (``offline``: predictions over a mapper,
R^2 / bias / RMSE per variable, level and domain, the column Jacobian),
the HTML report (``report``) and the ``prognostic_run_diags`` CLI
(``cli``: compute, metrics, report, movies, offline, log-viewer,
single-run, shell)."""

from .registry import Registry
from .compute import compute_diagnostics, DIAGNOSTICS_REGISTRY
from .offline import (
    column_jacobian,
    compute_offline_diagnostics,
    evaluate,
    predict_over_mapper,
)
from .report import HTMLReport, create_html, generate_run_report, write_report

__all__ = [
    "Registry",
    "compute_diagnostics",
    "DIAGNOSTICS_REGISTRY",
    "column_jacobian",
    "compute_offline_diagnostics",
    "evaluate",
    "predict_over_mapper",
    "HTMLReport",
    "create_html",
    "generate_run_report",
    "write_report",
]
