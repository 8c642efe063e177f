"""The port's prognostic-run diagnostics (``diagnostics.registry``,
``transforms``, ``compute``, ``metrics``, ``report.generate_run_report``)
against the JAX package's on a seeded C12 x 8 run with verification, on
the CPU in float64.

Tolerances.  Every group but the pressure-level ones is the same host
numpy code on the same arrays in both packages: equal, NaN for NaN.  The
pressure-level groups (``pressure_level_zonal_time_mean``,
``pressure_level_zonal_bias``, ``300_700_zonal_mean_value``) interpolate
in torch (the port) and in jnp (the JAX package): the same float64
products summed in another order, within PL_RTOL 1e-12 of each group's
scale (tests/test_torch_interpolate.py).  The metrics read the groups
that are equal in both: equal."""

import numpy as np
import pytest
import torch

from fv3net_tpu.diagnostics import compute as jcompute
from fv3net_tpu.diagnostics import metrics as jmetrics
from fv3net_tpu.diagnostics import registry as jregistry
from fv3net_tpu.diagnostics import transforms as jtrans
from fv3net_tpu_torch.diagnostics import compute as tcompute
from fv3net_tpu_torch.diagnostics import metrics as tmetrics
from fv3net_tpu_torch.diagnostics import registry as tregistry
from fv3net_tpu_torch.diagnostics import transforms as ttrans
from fv3net_tpu_torch.grid import CubedSphereGrid

torch.set_num_threads(1)

N, NZ, NT = 12, 8, 30
DT_HOURS = 6.0  # 4 samples a day: the 7-day RMSE reads sample 28
PL_RTOL = 1e-12
PRESSURE_LEVEL = ("pressure_level_zonal_time_mean",
                  "pressure_level_zonal_bias", "300_700_zonal_mean_value")
TOA = ("total_sky_downward_shortwave_flux_at_top_of_atmosphere",
       "total_sky_upward_shortwave_flux_at_top_of_atmosphere",
       "total_sky_upward_longwave_flux_at_top_of_atmosphere")


def grid():
    g = CubedSphereGrid.make(N, halo=3)
    sl = g.interior
    rng = np.random.RandomState(0)
    delp = 1.0e5 / NZ * (0.9 + 0.2 * rng.rand(NT, 6, NZ, N, N))
    return {
        "area": np.asarray(g.area[sl]), "lat": np.asarray(g.lat[sl]),
        "lon": np.asarray(g.lon[sl]),
        "land_sea_mask": rng.randint(0, 3, (6, N, N)).astype(float),
        "delp": delp, "dt_hours": DT_HOURS, "t0_hour": 3.0,
    }


def run(seed):
    rng = np.random.RandomState(seed)

    def r2(scale, offset=0.0):
        return offset + scale * rng.randn(NT, 6, N, N)

    out = {
        "surface_pressure": r2(100.0, 1e5),
        "total_precipitation_rate": np.abs(r2(1e-5)),
        "evaporation": np.abs(r2(1e-5)),
        "total_water_path": r2(2.0, 30.0),
        "column_heating": r2(50.0),
        "air_temperature": 250.0 + 30.0 * rng.rand(NT, 6, NZ, N, N),
        "specific_humidity": 1e-2 * rng.rand(NT, 6, NZ, N, N),
    }
    for name, offset in zip(TOA, (340.0, 100.0, 240.0)):
        out[name] = r2(10.0, offset)
    return out


@pytest.fixture(scope="module")
def args():
    g, pred, verif = grid(), run(1), run(2)
    return (jtrans.DiagArg(pred, verif, g),
            ttrans.DiagArg(pred, verif, g, torch.device("cpu")))


@pytest.fixture(scope="module")
def computed():
    g, pred, verif = grid(), run(1), run(2)
    j = jcompute.compute_diagnostics(pred, grid=g, verification=verif)
    t = tcompute.compute_diagnostics(pred, grid=g, verification=verif,
                                     device="cpu")
    return j, t


def assert_group(got, want, pressure_level):
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        if pressure_level:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            ok = ~np.isnan(w)
            np.testing.assert_allclose(
                g[ok], w[ok], rtol=0, atol=PL_RTOL * np.abs(w[ok]).max())
        else:
            np.testing.assert_array_equal(g, w)


def test_registries_match():
    assert list(tcompute.DIAGNOSTICS_REGISTRY.funcs) == list(
        jcompute.DIAGNOSTICS_REGISTRY.funcs)
    assert list(tmetrics.metrics_registry.funcs) == list(
        jmetrics.metrics_registry.funcs)


@pytest.mark.parametrize("name", list(jcompute.DIAGNOSTICS_REGISTRY.funcs))
def test_diagnostic_group(args, name):
    """Each registered diagnostic on the same DiagArg: non-empty, and
    equal to the JAX package's (pressure-level groups within PL_RTOL)."""
    jarg, targ = args
    want = jcompute.DIAGNOSTICS_REGISTRY.funcs[name](jarg)
    got = tcompute.DIAGNOSTICS_REGISTRY.funcs[name](targ)
    assert want, f"{name}: empty on the seeded run"
    assert_group(got, want, name in PRESSURE_LEVEL)


@pytest.mark.parametrize("name", list(jmetrics.metrics_registry.funcs))
def test_metric(args, computed, name):
    """Each registered metric from each package's own diagnostics."""
    jarg, targ = args
    (jd, _), (td, _) = computed
    want = jmetrics.metrics_registry.funcs[name](jd, jarg)
    got = tmetrics.metrics_registry.funcs[name](td, targ)
    assert want, f"{name}: empty on the seeded run"
    assert got == want


def test_compute_diagnostics(computed):
    """The whole compute: the same diagnostics and metrics."""
    (jd, jm), (td, tm) = computed
    assert sorted(td) == sorted(jd)
    for k in jd:
        assert_group({k: td[k]}, {k: jd[k]},
                     any(k.endswith("_" + g) for g in PRESSURE_LEVEL))
    assert tm == jm and len(tm) > 50


def test_compute_diagnostics_needs_a_device():
    """Without a device the interpolation's device is the card: where
    there is none the entry point raises before any group runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is the default here")
    with pytest.raises(RuntimeError, match="compute_diagnostics"):
        tcompute.compute_diagnostics(run(1), grid=grid())


@pytest.mark.parametrize("mask", ["global", "land", "sea", "seaice",
                                  "tropics", "tropics20"])
def test_mask_area(mask):
    g = grid()
    np.testing.assert_array_equal(ttrans.mask_area(mask, g),
                                  jtrans.mask_area(mask, g))


@pytest.mark.parametrize("fn", ["resample_time", "weighted_mean",
                                "zonal_average", "diurnal_cycle",
                                "histogram"])
def test_transform(fn):
    """The host transforms give the JAX package's results."""
    g, r = grid(), run(3)
    arr = r["surface_pressure"]
    calls = {
        "resample_time": lambda m: m.resample_time(r, 4),
        "weighted_mean": lambda m: m.weighted_mean(arr, g["area"][None],
                                                   (1, 2, 3)),
        "zonal_average": lambda m: m.zonal_average(arr, g["lat"],
                                                   g["area"]),
        "diurnal_cycle": lambda m: m.diurnal_cycle(arr, g["lon"],
                                                   g["area"], DT_HOURS),
        "histogram": lambda m: m.histogram(arr, g["area"],
                                           np.linspace(9.9e4, 1.01e5, 21)),
    }

    def arrays(out):
        if isinstance(out, dict):
            return [out[k] for k in sorted(out)]
        return list(out) if isinstance(out, tuple) else [out]

    want, got = arrays(calls[fn](jtrans)), arrays(calls[fn](ttrans))
    assert len(got) == len(want)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x, w)


def test_interpolate_to_pressure():
    g, r = grid(), run(4)
    field, delp = r["air_temperature"][0], g["delp"][0]
    want = jtrans.interpolate_to_pressure(field, delp)
    got = ttrans.interpolate_to_pressure(field, delp, device="cpu")
    assert_group({"t": got}, {"t": want}, True)


@pytest.mark.parametrize("workers", [1, 4])
def test_registry_fanout(workers):
    """Both registries: the same outputs and failure handling, serial or
    over a thread pool."""
    outs = []
    for mod in (jregistry, tregistry):
        reg = mod.Registry()
        reg.register("a")(lambda x: {"v": x * 2})
        reg.register("b")(lambda x: x + 1)

        @reg.register("boom")
        def _boom(x):
            raise RuntimeError("intentional")

        with pytest.raises(ValueError):
            reg.register("a")(lambda x: x)
        outs.append(reg.compute(3, workers=workers))
    assert outs[0] == outs[1] == {"v_a": 6, "b": 4}


def test_generate_run_report(tmp_path):
    """compute + report from a zarr-lite store (area only, as the JAX
    package's test_aux_components): the same HTML but its time stamp."""
    import re

    from fv3net_tpu.diagnostics.report import generate_run_report as jgen
    from fv3net_tpu_torch.diagnostics.report import generate_run_report
    from fv3net_tpu_torch.io.zarr_lite import ZarrLiteStore

    store = ZarrLiteStore(str(tmp_path / "run.zarr"))
    data = np.random.RandomState(5).rand(3, 6, N, N).astype(np.float32)
    store.create_array("wvp", shape=data.shape, chunks=(1, 6, N, N),
                       dtype=np.float32, dims=("time", "tile", "y", "x"))
    store.write_full("wvp", data)
    area = grid()["area"]
    pages = []
    for gen, kw in ((jgen, {}), (generate_run_report, {"device": "cpu"})):
        path = gen(str(tmp_path / "run.zarr"), area,
                   str(tmp_path / f"report{len(pages)}.html"), **kw)
        pages.append(re.sub(r"created \S+", "", open(path).read()))
    assert pages[0] == pages[1]
    assert "<svg" in pages[1] and "scalar metrics" in pages[1]
