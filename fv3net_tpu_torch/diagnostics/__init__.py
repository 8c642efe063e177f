"""Diagnostics of the port (the JAX package's ``diagnostics/``): the
offline evaluation of a trained model (``offline``: predictions over a
mapper, R^2 / bias / RMSE per variable, level and domain, the column
Jacobian, the HTML report), the ``offline`` subcommand of the CLI
(``cli``) and the HTML report (``report``).  Still to port: the
prognostic-run diagnostics (``compute.py`` with its registry, metrics and
transforms, which need ``utils/interpolate.py``) and the CLI's other
subcommands that read them."""

from .offline import (
    column_jacobian,
    compute_offline_diagnostics,
    evaluate,
    predict_over_mapper,
)
from .report import HTMLReport, create_html, write_report

__all__ = [
    "column_jacobian",
    "compute_offline_diagnostics",
    "evaluate",
    "predict_over_mapper",
    "HTMLReport",
    "create_html",
    "write_report",
]
