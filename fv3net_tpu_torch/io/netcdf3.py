"""Pure-Python NetCDF classic (CDF-1/CDF-2) reader and writer (a copy of
the JAX package's ``io/netcdf3.py``).

FV3GFS restart files (``fv_core.res.tile?.nc`` etc.) are NetCDF
"classic format" files written by FMS.  The reference reads them with
xarray/netCDF4 (`external/vcm/vcm/fv3_restarts/io.py:89-91`); neither
library's C backend is assumed here, so the framework carries its own
implementation of the on-disk format — the classic header (dim list,
attribute list, variable list), fixed-size variable slabs, and the
interleaved record-variable section, in both the 32-bit (CDF-1) and
64-bit-offset (CDF-2) variants.  Validated against scipy.io.netcdf_file
as an independent oracle in the JAX package's tests.

Everything is big-endian; attribute values and data slabs are padded to
4-byte boundaries; ``vsize`` is the padded slab size except in the
single-record-variable special case where records pack contiguously.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np

NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
NC_DIMENSION, NC_VARIABLE, NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C
ABSENT = b"\x00\x00\x00\x00\x00\x00\x00\x00"
STREAMING = 0xFFFFFFFF

_TYPE_TO_DTYPE = {
    NC_BYTE: np.dtype(">i1"),
    NC_CHAR: np.dtype("S1"),
    NC_SHORT: np.dtype(">i2"),
    NC_INT: np.dtype(">i4"),
    NC_FLOAT: np.dtype(">f4"),
    NC_DOUBLE: np.dtype(">f8"),
}
_KIND_TO_TYPE = {
    ("i", 1): NC_BYTE,
    ("S", 1): NC_CHAR,
    ("i", 2): NC_SHORT,
    ("i", 4): NC_INT,
    ("f", 4): NC_FLOAT,
    ("f", 8): NC_DOUBLE,
}


class Variable(NamedTuple):
    """One netCDF variable: data plus named dimensions and attributes."""

    data: np.ndarray
    dims: Tuple[str, ...]
    attrs: Dict[str, Any]


class Dataset(NamedTuple):
    dimensions: Dict[str, Optional[int]]  # record dim has None length
    variables: Dict[str, Variable]
    attrs: Dict[str, Any]


# ----------------------------------------------------------------------
# reader
# ----------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated netCDF file")
        self.pos += n
        return out

    def i4(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def u4(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def i8(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def name(self) -> str:
        n = self.i4()
        raw = self.take(n)
        self.take((4 - n % 4) % 4)  # padding
        return raw.decode("utf-8")

    def attr_value(self):
        nc_type = self.i4()
        nelems = self.i4()
        dtype = _TYPE_TO_DTYPE[nc_type]
        nbytes = nelems * dtype.itemsize
        raw = self.take(nbytes)
        self.take((4 - nbytes % 4) % 4)
        if nc_type == NC_CHAR:
            return raw.decode("utf-8", errors="replace")
        arr = np.frombuffer(raw, dtype=dtype)
        if nelems == 1:
            return arr[0].item()
        return arr.astype(dtype.newbyteorder("="))

    def attr_list(self) -> Dict[str, Any]:
        tag = self.i4()
        count = self.i4()
        if tag == 0 and count == 0:
            return {}
        if tag != NC_ATTRIBUTE:
            raise ValueError(f"bad attribute-list tag {tag}")
        return {self.name(): self.attr_value() for _ in range(count)}


def loads(buf: bytes) -> Dataset:
    """Parse a NetCDF classic byte string into a Dataset."""
    r = _Reader(buf)
    magic = r.take(3)
    if magic != b"CDF":
        raise ValueError("not a NetCDF classic file (bad magic)")
    version = r.take(1)[0]
    if version not in (1, 2):
        raise ValueError(f"unsupported netCDF version byte {version}")
    numrecs = r.u4()

    # dimensions
    tag, count = r.i4(), r.i4()
    dim_names: List[str] = []
    dim_sizes: List[int] = []
    if not (tag == 0 and count == 0):
        if tag != NC_DIMENSION:
            raise ValueError(f"bad dimension-list tag {tag}")
        for _ in range(count):
            dim_names.append(r.name())
            dim_sizes.append(r.i4())

    gattrs = r.attr_list()

    # variables
    tag, count = r.i4(), r.i4()
    var_meta = []
    if not (tag == 0 and count == 0):
        if tag != NC_VARIABLE:
            raise ValueError(f"bad variable-list tag {tag}")
        for _ in range(count):
            vname = r.name()
            ndims = r.i4()
            dimids = [r.i4() for _ in range(ndims)]
            vattrs = r.attr_list()
            nc_type = r.i4()
            vsize = r.u4()
            begin = r.i8() if version == 2 else r.u4()
            var_meta.append((vname, dimids, vattrs, nc_type, vsize, begin))

    record_dim = next((i for i, s in enumerate(dim_sizes) if s == 0), None)

    # resolve a STREAMING numrecs from the file size
    rec_vars = [m for m in var_meta if record_dim in m[1]]
    if numrecs == STREAMING and rec_vars:
        recsize = sum(m[4] for m in rec_vars)
        if len(rec_vars) == 1:
            m = rec_vars[0]
            shape = [dim_sizes[d] for d in m[1] if d != record_dim]
            recsize = int(np.prod(shape, dtype=np.int64)) * _TYPE_TO_DTYPE[
                m[3]
            ].itemsize
        first = min(m[5] for m in rec_vars)
        numrecs = (len(buf) - first) // max(recsize, 1)

    variables: Dict[str, Variable] = {}
    recsize = sum(m[4] for m in rec_vars)
    single_record = len(rec_vars) == 1
    for vname, dimids, vattrs, nc_type, vsize, begin in var_meta:
        dtype = _TYPE_TO_DTYPE[nc_type]
        dims = tuple(dim_names[d] for d in dimids)
        if record_dim is not None and record_dim in dimids:
            fixed_shape = tuple(
                dim_sizes[d] for d in dimids if d != record_dim
            )
            per_rec = int(np.prod(fixed_shape, dtype=np.int64)) * dtype.itemsize
            stride = per_rec if single_record else recsize
            out = np.empty((numrecs,) + fixed_shape, dtype=dtype)
            flat = out.reshape(numrecs, -1)
            for rec in range(numrecs):
                off = begin + rec * stride
                flat[rec] = np.frombuffer(
                    buf[off : off + per_rec], dtype=dtype
                )
            data = out
        else:
            shape = tuple(dim_sizes[d] for d in dimids)
            n = int(np.prod(shape, dtype=np.int64))
            data = np.frombuffer(
                buf[begin : begin + n * dtype.itemsize], dtype=dtype
            ).reshape(shape)
        data = data.astype(dtype.newbyteorder("="))
        variables[vname] = Variable(data, dims, vattrs)

    dimensions: Dict[str, Optional[int]] = {}
    for i, (nm, sz) in enumerate(zip(dim_names, dim_sizes)):
        dimensions[nm] = None if i == record_dim else sz
    return Dataset(dimensions, variables, gattrs)


def read(path: str) -> Dataset:
    with open(path, "rb") as f:
        return loads(f.read())


# ----------------------------------------------------------------------
# writer
# ----------------------------------------------------------------------


def _nc_type_for(arr: np.ndarray) -> int:
    a = np.asarray(arr)
    if a.dtype.kind == "S" or a.dtype.kind == "U":
        return NC_CHAR
    if a.dtype.kind == "b":
        return NC_BYTE
    key = (a.dtype.kind, a.dtype.itemsize)
    if key not in _KIND_TO_TYPE:
        # downcast unsupported widths (i8 -> i4, f2 -> f4)
        if a.dtype.kind == "i":
            return NC_INT
        if a.dtype.kind == "f":
            return NC_FLOAT
        raise TypeError(f"cannot store dtype {a.dtype} in netCDF classic")
    return _KIND_TO_TYPE[key]


def _encode_name(name: str) -> bytes:
    raw = name.encode("utf-8")
    return (
        struct.pack(">i", len(raw)) + raw + b"\x00" * ((4 - len(raw) % 4) % 4)
    )


def _encode_attr_value(value) -> bytes:
    if isinstance(value, str):
        raw = value.encode("utf-8")
        out = struct.pack(">ii", NC_CHAR, len(raw)) + raw
        return out + b"\x00" * ((4 - len(raw) % 4) % 4)
    arr = np.atleast_1d(np.asarray(value))
    nc_type = _nc_type_for(arr)
    dtype = _TYPE_TO_DTYPE[nc_type]
    raw = arr.astype(dtype).tobytes()
    out = struct.pack(">ii", nc_type, arr.size) + raw
    return out + b"\x00" * ((4 - len(raw) % 4) % 4)


def _encode_attr_list(attrs: Mapping[str, Any]) -> bytes:
    if not attrs:
        return ABSENT
    out = struct.pack(">ii", NC_ATTRIBUTE, len(attrs))
    for k, v in attrs.items():
        out += _encode_name(k) + _encode_attr_value(v)
    return out


def dumps(ds: Dataset, version: int = 2) -> bytes:
    """Serialize a Dataset to NetCDF classic bytes (CDF-2 by default)."""
    record_dim = next(
        (nm for nm, sz in ds.dimensions.items() if sz is None), None
    )
    dim_names = list(ds.dimensions)
    dim_index = {nm: i for i, nm in enumerate(dim_names)}

    numrecs = 0
    for v in ds.variables.values():
        if record_dim is not None and v.dims and v.dims[0] == record_dim:
            numrecs = max(numrecs, v.data.shape[0])

    header = b"CDF" + bytes([version]) + struct.pack(">I", numrecs)
    if dim_names:
        header += struct.pack(">ii", NC_DIMENSION, len(dim_names))
        for nm in dim_names:
            sz = ds.dimensions[nm]
            header += _encode_name(nm) + struct.pack(
                ">i", 0 if sz is None else sz
            )
    else:
        header += ABSENT
    header += _encode_attr_list(ds.attrs)

    # variable entries: compute sizes first, offsets second
    entries = []
    rec_vars = []
    for vname, v in ds.variables.items():
        nc_type = _nc_type_for(v.data)
        dtype = _TYPE_TO_DTYPE[nc_type]
        dimids = [dim_index[d] for d in v.dims]
        is_record = record_dim is not None and v.dims[:1] == (record_dim,)
        fixed_shape = v.data.shape[1:] if is_record else v.data.shape
        nbytes = int(np.prod(fixed_shape, dtype=np.int64)) * dtype.itemsize
        vsize = nbytes + ((4 - nbytes % 4) % 4)
        entries.append(
            dict(
                name=vname, dimids=dimids, attrs=v.attrs, nc_type=nc_type,
                vsize=vsize, nbytes=nbytes, is_record=is_record,
                data=v.data, dtype=dtype,
            )
        )
        if is_record:
            rec_vars.append(entries[-1])

    if ds.variables:
        var_header = struct.pack(">ii", NC_VARIABLE, len(entries))
    else:
        var_header = ABSENT

    # first pass with dummy offsets to size the header
    def entry_bytes(e, begin):
        out = _encode_name(e["name"])
        out += struct.pack(">i", len(e["dimids"]))
        out += b"".join(struct.pack(">i", d) for d in e["dimids"])
        out += _encode_attr_list(e["attrs"])
        out += struct.pack(">iI", e["nc_type"], e["vsize"])
        out += (
            struct.pack(">q", begin)
            if version == 2
            else struct.pack(">I", begin)
        )
        return out

    dummy = var_header + b"".join(entry_bytes(e, 0) for e in entries)
    data_start = len(header) + len(dummy)

    offset = data_start
    for e in entries:  # fixed-size variables first, in declaration order
        if not e["is_record"]:
            e["begin"] = offset
            offset += e["vsize"]
    rec_start = offset
    single_record = len(rec_vars) == 1
    recsize = 0
    for e in rec_vars:
        e["begin"] = rec_start + recsize
        recsize += e["nbytes"] if single_record else e["vsize"]

    body = var_header + b"".join(entry_bytes(e, e["begin"]) for e in entries)
    out = bytearray(header + body)
    total = rec_start + numrecs * recsize
    out.extend(b"\x00" * (total - len(out)))

    for e in entries:
        raw_dtype = e["dtype"]
        if not e["is_record"]:
            raw = np.ascontiguousarray(e["data"], dtype=raw_dtype).tobytes()
            out[e["begin"] : e["begin"] + len(raw)] = raw
        else:
            stride = e["nbytes"] if single_record else recsize
            flat = np.ascontiguousarray(e["data"], dtype=raw_dtype).reshape(
                e["data"].shape[0], -1
            )
            for rec in range(e["data"].shape[0]):
                off = e["begin"] + rec * stride
                raw = flat[rec].tobytes()
                out[off : off + len(raw)] = raw
    return bytes(out)


def write(path: str, ds: Dataset, version: int = 2) -> None:
    with open(path, "wb") as f:
        f.write(dumps(ds, version=version))
