"""fv3net_tpu_torch grid: the copied geometry and the torch halo gathers
against the JAX package at C12 (bit for bit: both are pure copies)."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.grid import geometry as jgeo
from fv3net_tpu.grid import halo as jhalo
from fv3net_tpu_torch.grid import geometry as tgeo
from fv3net_tpu_torch.grid import halo as thalo

torch.set_num_threads(1)

N_C12, H, NZ = 12, 3, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cubed_sphere_grid_bitwise():
    a = jgeo.CubedSphereGrid.make(N_C12, halo=H)
    b = tgeo.CubedSphereGrid.make(N_C12, halo=H)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(y, x, err_msg=f.name)
        else:
            assert x == y, f.name


def _fields(kind, rng):
    n = N_C12
    if kind in ("dgrid", "average"):
        return rng.randn(6, NZ, n + 1, n), rng.randn(6, NZ, n, n + 1)
    if kind.startswith("cgrid") or kind == "canon":
        return rng.randn(6, NZ, n, n + 1), rng.randn(6, NZ, n + 1, n)
    return (rng.randn(6, NZ, n, n),)


EXCHANGES = {
    "scalar-none": lambda mod, a: mod.halo_exchange(a[0], H, "none"),
    "scalar-x": lambda mod, a: mod.halo_exchange(a[0], H, "x"),
    "scalar-y": lambda mod, a: mod.halo_exchange(a[0], H, "y"),
    "dgrid": lambda mod, a: mod.halo_exchange_dgrid(*a, H),
    "cgrid-x": lambda mod, a: mod.halo_exchange_cgrid(*a, H, fill="x"),
    "cgrid-y": lambda mod, a: mod.halo_exchange_cgrid(*a, H, fill="y"),
    "canon": lambda mod, a: mod.canonicalize_cgrid_boundary(*a),
    "average": lambda mod, a: mod.average_dgrid_boundary(*a),
    "extend": lambda mod, a: mod.extend_cells_one(a[0]),
}


@pytest.mark.parametrize("kind", sorted(EXCHANGES))
def test_exchange_matches_jax(kind):
    """Each exchange is a gather over the same tables: exact equality."""
    arrays = _fields(kind, np.random.RandomState(0))
    fn = EXCHANGES[kind]
    want = fn(jhalo, [jnp.asarray(a) for a in arrays])
    got = fn(thalo, [torch.as_tensor(a) for a in arrays])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_exchange_2d_field():
    """A single-level [6, n, n] field takes the same gather."""
    q = np.random.RandomState(1).randn(6, N_C12, N_C12)
    want = jhalo.halo_exchange(jnp.asarray(q), H, "y")
    got = thalo.halo_exchange(torch.as_tensor(q), H, "y")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_import_leaves_jax_out():
    """Every module of fv3net_tpu_torch (walked with pkgutil, so a new
    module is covered without a hand list; the host-code subpackages io/,
    data/ and the physics/ modules of the nudged run among them, and every
    module file of fit/, emulation/, diagnostics/, utils/ and viz/)
    imports without jax, without fv3net_tpu, without scikit-learn (which
    the scikit-learn models import only where one is trained or loaded)
    and without matplotlib (which viz/ and the movies subcommand import
    only where they plot)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fv3net_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "assert len(mods) >= 40, mods\n"
        "for sub in ('io.netcdf3', 'io.restarts', 'data.batches',"
        " 'data.mappers', 'data.sequences', 'data.synth', 'physics.gfdl_mp',"
        " 'physics.convection', 'physics.land', 'runtime.nudging'):\n"
        "    assert 'fv3net_tpu_torch.' + sub in mods, sub\n"
        "import glob, os\n"
        "for pkg_dir, least in (('fit', 13), ('emulation', 5),"
        " ('diagnostics', 8), ('utils', 11), ('viz', 3)):\n"
        "    files = glob.glob(os.path.join(pkg.__path__[0], pkg_dir, '*.py'))\n"
        "    assert len(files) >= least, files\n"
        "    for f in files:\n"
        "        stem = os.path.basename(f)[:-3]\n"
        "        name = 'fv3net_tpu_torch.' + pkg_dir + (\n"
        "            '' if stem == '__init__' else '.' + stem)\n"
        "        assert name in mods + ['fv3net_tpu_torch.' + pkg_dir], name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'fv3net_tpu', 'sklearn', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
