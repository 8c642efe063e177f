"""Training-data contracts (loaders package equivalents; a copy of the
JAX package's ``data/batches.py``).

The reference's loaders package exposes a registry of batch-producing
functions configured by name (loaders/_config.py:14,
batches_functions) plus mappers over zarr stores.  Here batches are
sequences of Quantity-dict states; sources are zarr-lite stores (run
diagnostics / restart output) or synthetic generators (the synth
package's role, external/synth/synth/core.py)."""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import numpy as np

from ..io.zarr_lite import ZarrLiteStore
from ..util.quantity import Quantity

batches_functions: Dict[str, Callable] = {}


def register_batches_function(name):
    def wrap(fn):
        batches_functions[name] = fn
        return fn

    return wrap


@register_batches_function("batches_from_zarr")
def batches_from_zarr(
    path: str,
    variables: Sequence[str],
    batch_dim: str = "time",
) -> Sequence[Mapping[str, Quantity]]:
    """Each entry along the batch (time) dimension becomes one batch."""
    store = ZarrLiteStore(path)
    arrays = {}
    dims = {}
    for v in variables:
        arrays[v] = store.read(v)
        dims[v] = tuple(store.attrs(v).get("_ARRAY_DIMENSIONS", []))
    n = min(a.shape[0] for a in arrays.values())
    batches = []
    for i in range(n):
        batches.append(
            {
                v: Quantity(arrays[v][i], dims[v][1:], "")
                for v in variables
            }
        )
    return batches


@register_batches_function("batches_from_serialized")
def batches_from_serialized(
    path: str,
    variables: Sequence[str] = (),
    savepoints_per_batch: int = 1,
    store_name: str = "state_output.zarr",
) -> Sequence[Mapping[str, Quantity]]:
    """Batches over emulation StorageHook capture output
    (loaders/batches/_batch.py:282 batches_from_serialized +
    _serialized_phys.py SerializedSequence/FlattenDims roles).

    The StorageHook (emulation/hooks.py:62) appends each captured
    physics state to ``<path>/state_output.zarr`` with a leading
    savepoint axis.  Each batch stacks ``savepoints_per_batch``
    savepoints and flattens every non-vertical dimension into a single
    ``sample`` dim — column fields become [sample, z], surface fields
    [sample, 1] — the layout the `transformed` emulator trainer
    consumes directly.
    """
    import os

    store_path = (
        os.path.join(path, store_name)
        if os.path.isdir(os.path.join(path, store_name))
        else path
    )
    store = ZarrLiteStore(store_path)
    names = list(variables) if variables else sorted(store.arrays())
    arrays = {v: store.read(v) for v in names}
    n_save = min(a.shape[0] for a in arrays.values())

    def flatten(a):
        # [sp, tile, z, y, x] -> [sp*tile*y*x, z];
        # [sp, tile, y, x] -> [sp*tile*y*x, 1]; [sp, ...] -> [sp, -1]
        if a.ndim == 5:
            return np.moveaxis(a, 2, -1).reshape(-1, a.shape[2])
        if a.ndim == 4:
            return a.reshape(-1, 1)
        return a.reshape(a.shape[0], -1)

    batches = []
    for i in range(0, n_save, savepoints_per_batch):
        sl = slice(i, min(i + savepoints_per_batch, n_save))
        batches.append(
            {
                v: Quantity(
                    flatten(arrays[v][sl]), ("sample", "z"), ""
                )
                for v in names
            }
        )
    return batches


class SyntheticWaves:
    """(fv3fit/data/synthetic.py:57): smooth wavy 3D fields."""

    def __init__(self, variables, n=8, nz=6, nbatch=4, seed=0,
                 amplitude=1.0):
        self.variables = list(variables)
        self.n = n
        self.nz = nz
        self.nbatch = nbatch
        self.seed = seed
        self.amplitude = amplitude

    def batches(self):
        rng = np.random.RandomState(self.seed)
        out = []
        x = np.linspace(0, 2 * np.pi, self.n)
        for _ in range(self.nbatch):
            batch = {}
            for v in self.variables:
                ph = rng.rand(3) * 2 * np.pi
                f = (
                    np.sin(x[None, None, :, None] * 0 + x[None, None,
                                                          None, :]
                           + ph[0])
                    + np.cos(x[None, None, :, None] + ph[1])
                )
                k = np.linspace(0, 1, self.nz).reshape(1, self.nz, 1, 1)
                arr = self.amplitude * f * (1.0 + k)
                arr = np.broadcast_to(
                    arr, (6, self.nz, self.n, self.n)
                ).copy()
                arr += 0.01 * rng.randn(*arr.shape)
                batch[v] = Quantity(
                    arr.astype(np.float32), ("tile", "z", "y", "x"), ""
                )
            out.append(batch)
        return out


class SyntheticNoise:
    """(fv3fit/data/synthetic.py:12)"""

    def __init__(self, variables, n=8, nz=6, nbatch=4, seed=0,
                 noise_amplitude=1.0):
        self.variables = list(variables)
        self.n = n
        self.nz = nz
        self.nbatch = nbatch
        self.seed = seed
        self.noise_amplitude = noise_amplitude

    def batches(self):
        rng = np.random.RandomState(self.seed)
        return [
            {
                v: Quantity(
                    (self.noise_amplitude
                     * rng.randn(6, self.nz, self.n, self.n)).astype(
                        np.float32
                    ),
                    ("tile", "z", "y", "x"),
                    "",
                )
                for v in self.variables
            }
            for _ in range(self.nbatch)
        ]


@register_batches_function("synthetic_waves")
def synthetic_waves_batches(**kwargs):
    return SyntheticWaves(**kwargs).batches()


@register_batches_function("synthetic_noise")
def synthetic_noise_batches(**kwargs):
    return SyntheticNoise(**kwargs).batches()


def open_batches_from_config(data_config: Mapping):
    """data_config: {"function": name, "kwargs": {...}}
    (tfdataset_loader_from_dict equivalent, fv3fit/train.py:138)."""
    fn = batches_functions[data_config["function"]]
    return fn(**data_config.get("kwargs", {}))


@register_batches_function("batches_from_netcdf")
def batches_from_netcdf(
    url: str,
    variables: Sequence[str],
    nfiles=None,
    shuffle: bool = True,
    seed: int = 0,
    sort_files: bool = False,
) -> Sequence[Mapping[str, Quantity]]:
    """Each NetCDF classic file in a directory becomes one batch
    (fv3fit NCDirLoader, fv3fit/data/netcdf/load.py:115: identical CDL
    per file, samples along the first dimension).  Files are read with
    the in-house codec (io/netcdf3.py); order is shuffled by default
    with a fixed seed, matching the reference's loader."""
    import os

    from ..io import netcdf3

    files = [
        os.path.join(url, f)
        for f in sorted(os.listdir(url))
        if f.endswith(".nc")
    ]
    if sort_files:
        files.sort()
    elif shuffle:
        np.random.RandomState(seed).shuffle(files)
    if nfiles is not None:
        files = files[:nfiles]
    batches = []
    for path in files:
        ds = netcdf3.read(path)
        batch = {}
        for v in variables:
            var = ds.variables[v]
            batch[v] = Quantity(
                np.asarray(var.data, np.float32), var.dims,
                str(var.attrs.get("units", "")),
            )
        batches.append(batch)
    return batches
