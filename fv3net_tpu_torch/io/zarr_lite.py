"""Minimal zarr-v2-compatible array store (pure numpy, no dependencies;
a copy of the JAX package's ``io/zarr_lite.py``).

The reference streams diagnostics into zarr stores via pace.util's
ZarrMonitor (runtime/diagnostics/manager.py:82-96,
emulation/_monitor/monitor.py:58) and appends run segments by shifting
chunk files (fv3post/append.py:146).  The store does not depend on the
zarr package: it writes the zarr v2 format directly: per-array
directories holding a ``.zarray`` JSON descriptor, a ``.zattrs`` file,
and raw C-order chunk files named ``i.j.k`` -- readable by the real zarr
library (compressor: null).  Appending along a dimension only touches
the ``.zarray`` shape and writes new chunk files, which preserves the
reference's cheap segment-append property.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_DTYPE_MAP = {
    np.dtype("float32"): "<f4",
    np.dtype("float64"): "<f8",
    np.dtype("int32"): "<i4",
    np.dtype("int64"): "<i8",
    np.dtype("bool"): "|b1",
}


def _zarr_dtype(dt: np.dtype) -> str:
    try:
        return _DTYPE_MAP[np.dtype(dt)]
    except KeyError:
        raise ValueError(f"unsupported dtype for zarr-lite: {dt}")


class ZarrLiteStore:
    """A group of zarr v2 arrays rooted at a directory."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        zgroup = os.path.join(path, ".zgroup")
        if not os.path.exists(zgroup):
            with open(zgroup, "w") as f:
                json.dump({"zarr_format": 2}, f)

    # ----- writing -------------------------------------------------------

    def create_array(
        self,
        name: str,
        shape: Sequence[int],
        chunks: Sequence[int],
        dtype,
        dims: Optional[Sequence[str]] = None,
        attrs: Optional[Dict] = None,
        fill_value=0,
    ):
        adir = os.path.join(self.path, name)
        os.makedirs(adir, exist_ok=True)
        meta = {
            "zarr_format": 2,
            "shape": list(int(s) for s in shape),
            "chunks": list(int(c) for c in chunks),
            "dtype": _zarr_dtype(np.dtype(dtype)),
            "compressor": None,
            "fill_value": fill_value,
            "order": "C",
            "filters": None,
        }
        with open(os.path.join(adir, ".zarray"), "w") as f:
            json.dump(meta, f)
        a = dict(attrs or {})
        if dims is not None:
            a["_ARRAY_DIMENSIONS"] = list(dims)
        with open(os.path.join(adir, ".zattrs"), "w") as f:
            json.dump(a, f)

    def _meta(self, name: str) -> dict:
        with open(os.path.join(self.path, name, ".zarray")) as f:
            return json.load(f)

    def _set_meta(self, name: str, meta: dict):
        with open(os.path.join(self.path, name, ".zarray"), "w") as f:
            json.dump(meta, f)

    def write_chunk(self, name: str, chunk_index: Tuple[int, ...],
                    data: np.ndarray):
        """Write one chunk (data must be the full chunk shape, C-order).

        Partial trailing chunks are padded to the chunk shape as zarr
        requires.
        """
        meta = self._meta(name)
        chunks = meta["chunks"]
        dt = np.dtype(meta["dtype"])
        buf = np.zeros(chunks, dtype=dt)
        sl = tuple(slice(0, s) for s in data.shape)
        buf[sl] = data
        fname = ".".join(str(i) for i in chunk_index)
        with open(os.path.join(self.path, name, fname), "wb") as f:
            f.write(buf.astype(dt, copy=False).tobytes(order="C"))

    def write_full(self, name: str, data: np.ndarray):
        """Write a whole array (chunked automatically)."""
        meta = self._meta(name)
        chunks = meta["chunks"]
        shape = meta["shape"]
        grid = [
            (int(np.ceil(s / c))) for s, c in zip(shape, chunks)
        ]
        for idx in np.ndindex(*grid):
            sl = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, shape)
            )
            self.write_chunk(name, idx, data[sl])

    def append(self, name: str, data: np.ndarray, axis: int = 0):
        """Append along `axis`; data extent along axis must be a multiple
        of (or final partial) chunk size, starting at a chunk boundary."""
        meta = self._meta(name)
        shape = meta["shape"]
        chunks = meta["chunks"]
        if shape[axis] % chunks[axis] != 0:
            raise ValueError(
                "append requires existing extent at a chunk boundary"
            )
        start_chunk = shape[axis] // chunks[axis]
        new_shape = list(shape)
        new_shape[axis] += data.shape[axis]
        grid = [
            int(np.ceil(s / c))
            for s, c in zip(new_shape, chunks)
        ]
        grid[axis] = int(np.ceil(data.shape[axis] / chunks[axis]))
        for idx in np.ndindex(*grid):
            sl = []
            out_idx = list(idx)
            for d, (i, c) in enumerate(zip(idx, chunks)):
                if d == axis:
                    sl.append(
                        slice(i * c, min((i + 1) * c, data.shape[axis]))
                    )
                    out_idx[d] = start_chunk + i
                else:
                    sl.append(
                        slice(i * c, min((i + 1) * c, new_shape[d]))
                    )
            self.write_chunk(name, tuple(out_idx), data[tuple(sl)])
        meta["shape"] = new_shape
        self._set_meta(name, meta)

    # ----- reading -------------------------------------------------------

    def read(self, name: str) -> np.ndarray:
        meta = self._meta(name)
        shape = meta["shape"]
        chunks = meta["chunks"]
        dt = np.dtype(meta["dtype"])
        out = np.full(shape, meta.get("fill_value") or 0, dtype=dt)
        grid = [int(np.ceil(s / c)) for s, c in zip(shape, chunks)]
        for idx in np.ndindex(*grid):
            fname = ".".join(str(i) for i in idx)
            fpath = os.path.join(self.path, name, fname)
            if not os.path.exists(fpath):
                continue
            buf = np.frombuffer(
                open(fpath, "rb").read(), dtype=dt
            ).reshape(chunks)
            sl = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, shape)
            )
            spans = tuple(s.stop - s.start for s in sl)
            out[sl] = buf[tuple(slice(0, e) for e in spans)]
        return out

    def attrs(self, name: str) -> dict:
        p = os.path.join(self.path, name, ".zattrs")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def arrays(self):
        for entry in sorted(os.listdir(self.path)):
            if os.path.isdir(os.path.join(self.path, entry)):
                if os.path.exists(
                    os.path.join(self.path, entry, ".zarray")
                ):
                    yield entry


def rechunk_store(
    src_path: str,
    dst_path: str,
    chunks=None,
    cast=None,
    time_chunk: Optional[int] = None,
):
    """Rechunk + encode a whole store into a new one (the
    xpartition-style post-processing pass of the reference's
    `fv3post.post_process` rechunk/encode steps,
    workflows/post_process_run/fv3post/post_process.py:49-54).

    chunks: mapping array-name -> chunk tuple, or a single tuple
    applied where the rank matches; time_chunk: convenience override
    of the leading-axis chunk for every array; cast: target dtype for
    float arrays (the reference encodes float32), None = keep.

    Returns the destination store.
    """
    src = open_zarr_lite(src_path)
    dst = ZarrLiteStore(dst_path)
    for name in src.arrays():
        data = src.read(name)
        meta = src._meta(name)
        new_chunks = list(meta["chunks"])
        if isinstance(chunks, dict):
            if name in chunks:
                new_chunks = list(chunks[name])
        elif chunks is not None and len(chunks) == data.ndim:
            new_chunks = list(chunks)
        if time_chunk is not None and data.ndim >= 1:
            new_chunks[0] = int(time_chunk)
        new_chunks = [
            min(int(c), int(s))
            for c, s in zip(new_chunks, data.shape)
        ]
        attrs = src.attrs(name)
        dims = attrs.pop("_ARRAY_DIMENSIONS", None)
        # dimension COORDINATES keep their dtype: float64 epoch
        # timestamps quantize to ~128 s at f32 (the reference encodes
        # data variables, not coords)
        is_coord = (
            name == "time" or (dims is not None and dims == [name])
        )
        dt = data.dtype
        if (
            cast is not None
            and not is_coord
            and np.issubdtype(dt, np.floating)
        ):
            dt = np.dtype(cast)
        dst.create_array(
            name, data.shape, new_chunks, dt, dims=dims,
            attrs=attrs,
        )
        dst.write_full(name, data.astype(dt, copy=False))
    return dst


def open_zarr_lite(path: str) -> ZarrLiteStore:
    return ZarrLiteStore(path)
