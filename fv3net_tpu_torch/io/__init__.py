"""Host-side stores (numpy): the zarr-v2-compatible ``zarr_lite``."""

from .zarr_lite import ZarrLiteStore, open_zarr_lite

__all__ = ["ZarrLiteStore", "open_zarr_lite"]
