"""Host-side stores and files (numpy): the zarr-v2-compatible
``zarr_lite``, the NetCDF classic codec ``netcdf3`` and the Fortran
restart files ``restarts``."""

from .zarr_lite import ZarrLiteStore, open_zarr_lite

__all__ = ["ZarrLiteStore", "open_zarr_lite"]
