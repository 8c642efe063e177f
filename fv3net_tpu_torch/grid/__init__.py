from .geometry import CubedSphereGrid, gnomonic_grid
from .halo import (
    average_dgrid_boundary,
    canonicalize_cgrid_boundary,
    extend_cells_one,
    halo_exchange,
    halo_exchange_cgrid,
    halo_exchange_dgrid,
)

__all__ = [
    "CubedSphereGrid",
    "gnomonic_grid",
    "average_dgrid_boundary",
    "canonicalize_cgrid_boundary",
    "extend_cells_one",
    "halo_exchange",
    "halo_exchange_cgrid",
    "halo_exchange_dgrid",
]
