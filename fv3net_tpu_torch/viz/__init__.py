"""Cubed-sphere plotting (a copy of the JAX package's ``viz/``; the
external/fv3viz package's role, SURVEY 2.2: plot_cube
`_plot_cube.py:54`, pcolormesh_cube `_plot_cube.py:245`,
diurnal/time-series plots `_plot_diagnostics.py`, infer_cmap_params
`_plot_helpers.py`).

Host numpy and matplotlib, which every plotting function imports when
called: without matplotlib the package imports, and a plot raises
ImportError.  No cartopy, so maps render in equirectangular
(PlateCarree-equivalent) axes, which is what the reference's default
projection reduces to for pcolormesh_cube.
"""

from ._cube import infer_cmap_params, pcolormesh_cube, plot_cube
from ._diagnostics import plot_diurnal_cycle, plot_time_series

__all__ = [
    "plot_cube",
    "pcolormesh_cube",
    "infer_cmap_params",
    "plot_diurnal_cycle",
    "plot_time_series",
]
