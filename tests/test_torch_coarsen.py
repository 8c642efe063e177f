"""The port's coarsening pipeline (``utils.coarsen``, ``utils.metrics``,
``utils.coarsen_restarts``, ``utils.fine_res_budget``) against the JAX
package's, C24 -> C12 and C24 -> C6 (factors 2 and 4) on the hybrid
coordinate with a surface pressure that varies inside every coarse block
but the flat ones (terrain of 0, 250 or 450 m amplitude a block), in
float64 on the CPU.

Tolerances.  The block reductions, the surface methods and the host
metrics are the same operations on the same arrays: BLOCK_RTOL 1e-13 of
each output's scale (torch and numpy may sum a block in another order)
and equal where the output is a mode, a mask or a host computation.
The pressure method and the budget remap each column in both packages;
the JAX package integrates the PPM profile cumulatively and differences
it at the target edges, the port integrates each layer overlap
(quirk (h) of ROADMAP.md): the same float64 sums in another order, which
lose |M| eps / dp2 (M ~ 300 K x 1e5 Pa, dp2 ~ 1e3 Pa: ~1e-11 of q) in
the cumulative form; REMAP_RTOL 1e-10 of each output's scale holds both
(measured: <= 1e-15 relative to each field's largest value, 2.4e-14 for
an eddy flux, a difference of two such averages).  On the CPU the port's
remap is the plain form of K5's dispatch; ``remap_levels_mappm`` equals
``ppm_remap(exact_boundaries=False)`` bit for bit there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.dycore.hydro import hybrid_coefficients
from fv3net_tpu.ops import remap as jremap
from fv3net_tpu.utils import coarsen as jco
from fv3net_tpu.utils import coarsen_restarts as jcr
from fv3net_tpu.utils import fine_res_budget as jfb
from fv3net_tpu.utils import metrics as jme
from fv3net_tpu_torch.constants import GRAV, RDGAS
from fv3net_tpu_torch.ops import remap as tremap
from fv3net_tpu_torch.utils import coarsen as tco
from fv3net_tpu_torch.utils import coarsen_restarts as tcr
from fv3net_tpu_torch.utils import fine_res_budget as tfb
from fv3net_tpu_torch.utils import metrics as tme

torch.set_num_threads(1)

N, NZ = 24, 8
BLOCK_RTOL = 1e-13
REMAP_RTOL = 1e-10
DELP = "pressure_thickness_of_atmospheric_layer"
FACTORS = [2, 4]


def terrain(factor, seed=0):
    """Surface height [6, N, N] (m): a base per tile plus, per coarse
    block, white noise of amplitude 0 (flat), 250 or 450 m."""
    rng = np.random.RandomState(seed)
    nc = N // factor
    amp = rng.choice([0.0, 250.0, 450.0], size=(6, nc, nc))
    amp = np.repeat(np.repeat(amp, factor, 1), factor, 2)
    return 500.0 * rng.rand(6, 1, 1) + amp * rng.uniform(-1, 1, (6, N, N))


def fine_state(factor, seed=0):
    """Restart fields on the hybrid coordinate with ps from the terrain
    (ps = 1e5 exp(-h g / (Rd 288 K))), hydrostatic delz."""
    rng = np.random.RandomState(seed + 1)
    h = terrain(factor, seed)
    ps = 1.0e5 * np.exp(-h * GRAV / (RDGAS * 288.0))
    ak, bk = (np.asarray(c) for c in hybrid_coefficients(NZ, 300.0))
    pe = ak[None, :, None, None] + bk[None, :, None, None] * ps[:, None]
    delp = np.diff(pe, axis=1)
    temp = 250.0 + 30.0 * rng.rand(6, NZ, N, N)
    sphum = 1e-3 * rng.rand(6, NZ, N, N)
    state = {
        DELP: delp, "air_temperature": temp, "specific_humidity": sphum,
        "cloud_water_mixing_ratio": 1e-5 * rng.rand(6, NZ, N, N),
        "vertical_wind": rng.randn(6, NZ, N, N),
        "vertical_thickness_of_atmospheric_layer":
            jcr.impose_hydrostatic_balance(temp, sphum, delp),
        "x_wind": rng.randn(6, NZ, N + 1, N),
        "y_wind": rng.randn(6, NZ, N, N + 1),
        "surface_geopotential": GRAV * h,
        "slmsk": rng.randint(0, 3, (6, N, N)).astype(float),
    }
    area = 1.0 + 0.1 * rng.rand(6, N, N)
    return state, area


def host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, want, rtol, tag=""):
    g, w = host(got), np.asarray(want)
    assert g.shape == w.shape, tag
    scale = np.abs(w).max()
    np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale, err_msg=tag)


def close_dicts(got, want, rtol):
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], rtol, k)


# ---------------------------------------------------------------- coarsen


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("method", ["mean", "sum", "min", "max", "median"])
@pytest.mark.parametrize("factor", FACTORS + [3])
def test_block_coarsen(factor, method, kind):
    """Every reduction, on host arrays and on tensors (an odd block
    count for the median at factor 3)."""
    a = np.random.RandomState(factor).randn(2, 6, N, N)
    want = jco.block_coarsen(a, factor, method)
    x = torch.as_tensor(a) if kind == "tensor" else a
    got = tco.block_coarsen(x, factor, method)
    assert isinstance(got, torch.Tensor) == (kind == "tensor")
    close(got, want, BLOCK_RTOL)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("factor", FACTORS)
def test_block_functions(factor, kind):
    """weighted / edge-weighted averages, edge sums, mode and upsampling
    against the JAX package's."""
    rng = np.random.RandomState(10 + factor)
    t = (lambda a: torch.as_tensor(a)) if kind == "tensor" else (
        lambda a: a)
    a = rng.randn(6, NZ, N, N)
    w = 1.0 + rng.rand(6, 1, N, N)
    close(tco.weighted_block_average(t(a), t(w), factor),
          jco.weighted_block_average(a, w, factor), BLOCK_RTOL)
    xe = rng.randn(6, NZ, N + 1, N)
    dx = 1.0 + rng.rand(6, 1, N + 1, N)
    ye = rng.randn(6, NZ, N, N + 1)
    dy = 1.0 + rng.rand(6, 1, N, N + 1)
    for edge, sp, axis in ((xe, dx, -1), (ye, dy, -2)):
        close(tco.edge_weighted_block_average(t(edge), t(sp), factor, axis),
              jco.edge_weighted_block_average(edge, sp, factor, axis),
              BLOCK_RTOL)
        close(tco.block_edge_sum(t(edge), factor, axis),
              jco.block_edge_sum(edge, factor, axis), BLOCK_RTOL)
    cat = rng.randint(0, 4, (6, N, N)).astype(float)
    np.testing.assert_array_equal(tco.block_mode(t(cat), factor),
                                  jco.block_mode(cat, factor))
    c = rng.randn(6, N // factor, N // factor)
    np.testing.assert_array_equal(host(tco.block_upsample(t(c), factor)),
                                  jco.block_upsample(c, factor))
    with pytest.raises(ValueError):
        tco.block_coarsen(t(a[..., :-1]), factor)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("fn", [
    "mean_squared_error", "root_mean_squared_error", "bias",
    "mean_absolute_error", "r2_score",
])
@pytest.mark.parametrize("weighted", [False, True])
def test_skill_scores(fn, weighted, kind):
    rng = np.random.RandomState(3)
    truth, w = rng.randn(6, N, N), 1.0 + rng.rand(6, N, N)
    pred = truth + 0.3 * rng.randn(6, N, N)
    args = (truth, pred, w if weighted else None)
    want = getattr(jme, fn)(*args)
    if kind == "tensor":
        args = tuple(None if a is None else torch.as_tensor(a)
                     for a in args)
    close(getattr(tme, fn)(*args), want, BLOCK_RTOL)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("fn", ["accuracy", "precision", "recall",
                                "f1_score", "false_positive_rate"])
def test_classification_scores(fn, kind):
    rng = np.random.RandomState(4)
    truth, pred = rng.rand(200) > 0.4, rng.rand(200) > 0.5
    w = 1.0 + rng.rand(200)
    for weights in (None, w):
        want = getattr(jme, fn)(truth, pred, weights)
        args = (truth, pred, weights)
        if kind == "tensor":
            args = tuple(None if a is None else torch.as_tensor(a)
                         for a in args)
        close(getattr(tme, fn)(*args), want, BLOCK_RTOL)


def test_histograms_and_zonal_average():
    rng = np.random.RandomState(5)
    a, w = rng.randn(6, N, N), rng.rand(6, N, N)
    for got, want in (
            (tme.histogram(torch.as_tensor(a), weights=w),
             jme.histogram(a, weights=w)),
            (tme.histogram(a, bins=np.linspace(-3, 3, 7)),
             jme.histogram(a, bins=np.linspace(-3, 3, 7))),
            (tme.histogram2d(a, torch.as_tensor(w), bins=5),
             jme.histogram2d(a, w, bins=5))):
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
    lat = np.deg2rad(rng.uniform(-90, 90, (6, N, N)))
    for field in (rng.randn(6, N, N), rng.randn(3, 6, N, N),
                  rng.randn(6, 3, N, N)):
        for weights in (None, w):
            got = tme.zonal_average_approximate(
                torch.as_tensor(lat), torch.as_tensor(field),
                weights=weights)
            want = jme.zonal_average_approximate(lat, field,
                                                 weights=weights)
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g, x)


def test_data_transforms():
    from fv3net_tpu.util.quantity import Quantity as JQ
    from fv3net_tpu_torch.util.quantity import Quantity as TQ

    rng = np.random.RandomState(6)
    arrays = {k: rng.randn(6, NZ, N, N) for k in ("dQ1", "pQ1", "dQ2",
                                                 "pQ2")}
    dims = ("tile", "z", "y", "x")
    assert sorted(tme.DATA_TRANSFORM_REGISTRY) == sorted(
        jme.DATA_TRANSFORM_REGISTRY)
    for name in jme.DATA_TRANSFORM_REGISTRY:
        want = jme.apply_data_transform(
            name, {k: JQ(v, dims, "K/s") for k, v in arrays.items()})
        got = tme.apply_data_transform(
            name, {k: TQ(torch.as_tensor(v), dims, "K/s")
                   for k, v in arrays.items()})
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].values, want[k].values)


# ------------------------------------------------------- restart coarsening


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("method", ["sigma", "pressure", "blended"])
@pytest.mark.parametrize("factor", FACTORS)
def test_restart_methods(factor, method, kind):
    """The three restart methods on the same state (host arrays, and
    tensors on the CPU for the port), every output against the JAX
    package's; the categorical slmsk by block mode, equal."""
    state, area = fine_state(factor)
    phis = state["surface_geopotential"]
    calls = {
        "sigma": (jcr.coarsen_restarts_on_sigma,
                  tcr.coarsen_restarts_on_sigma, {}),
        "pressure": (jcr.coarsen_restarts_on_pressure,
                     tcr.coarsen_restarts_on_pressure, {"device": "cpu"}),
        "blended": (
            lambda *a: jcr.coarsen_restarts_via_blended_method(
                *a, phis=phis),
            tcr.coarsen_restarts_via_blended_method,
            {"phis": phis, "device": "cpu"}),
    }
    jfn, tfn, kw = calls[method]
    want = jfn(state, area, factor)
    if kind == "tensor":
        state = {k: torch.as_tensor(v) for k, v in state.items()}
        area = torch.as_tensor(area)
        kw = {k: torch.as_tensor(v) if k == "phis" else v
              for k, v in kw.items()}
    got = tfn(state, area, factor, **kw)
    rtol = BLOCK_RTOL if method == "sigma" else REMAP_RTOL
    close_dicts(got, want, rtol)
    np.testing.assert_array_equal(got["slmsk"], want["slmsk"])
    nc = N // factor
    assert host(got["x_wind"]).shape == (6, NZ, nc + 1, nc)


@pytest.mark.parametrize("factor", FACTORS)
def test_pressure_method_remaps_inside_blocks(factor):
    """The pressure method differs from the sigma method where ps varies
    inside a block and equals it to roundoff where the block is flat
    (its columns already sit on the block-mean pressure)."""
    state, area = fine_state(factor)
    sig = tcr.coarsen_restarts_on_sigma(state, area, factor)
    pre = tcr.coarsen_restarts_on_pressure(state, area, factor,
                                           device="cpu")
    ps = state[DELP].sum(1)
    spread = tco.block_coarsen(ps, factor, "max") - tco.block_coarsen(
        ps, factor, "min")
    diff = np.abs(pre["air_temperature"] - sig["air_temperature"]).max(1)
    flat = spread == 0.0
    assert flat.any() and (~flat).any()
    assert diff[flat].max() <= 1e-10 * 300.0
    assert diff[~flat].max() > 1e-3


@pytest.mark.parametrize("kord", [9, 10, -9, 6])
def test_remap_levels_mappm(kord):
    """remap_levels_mappm on the native layout equals the plain
    ppm_remap with mappm's rules, bit for bit on the CPU, for variants
    the kernel covers (9, 10) and those it does not (-9, 6), with target
    edges above and below the source column; and the JAX package's
    ppm_remap within REMAP_RTOL (but at kord 10, whose limiter sits on
    exact ties in these white-noise columns, where a 1-ulp difference
    takes the other branch: tests/test_torch_remap.py holds that profile
    against the mappm oracle outside its ties)."""
    rng = np.random.RandomState(7)
    w = np.cumsum(0.2 + rng.rand(2, NZ + 1, 5, 5), axis=1)
    pe1 = 300.0 + (w - w[:, :1]) / (w[:, -1:] - w[:, :1]) * 1e5
    pe2 = pe1 * (1.0 + 0.05 * (rng.rand(2, 1, 5, 5) - 0.5))
    pe2[:, 0] = 300.0 * (0.5 + rng.rand(2, 5, 5))
    q = 1.0 + rng.randn(2, NZ, 5, 5)
    t = [torch.as_tensor(a) for a in (q, pe1, pe2)]
    got = tremap.remap_levels_mappm(*t, 1, kord)
    plain = tremap.ppm_remap(*(a.movedim(1, 0) for a in t), iv=1,
                             kord=kord).movedim(0, 1)
    assert torch.equal(got, plain)
    if kord == 10:
        return
    want = np.moveaxis(np.asarray(jremap.ppm_remap(
        *(jnp.asarray(np.moveaxis(a, 1, 0)) for a in (q, pe1, pe2)),
        iv=1, kord=kord)), 0, 1)
    close(got, want, REMAP_RTOL)


def test_hydrostatic_balance_and_blending_weight():
    """impose_hydrostatic_balance and blending_weight on host arrays and
    tensors; the weight is 1 on the flat blocks, 0 on the roughest and
    strictly between on the others."""
    factor = 4
    state, area = fine_state(factor)
    args = [state[k] for k in ("air_temperature", "specific_humidity",
                               DELP)]
    want = jcr.impose_hydrostatic_balance(*args, ptop=300.0)
    for a in (args, [torch.as_tensor(x) for x in args]):
        close(tcr.impose_hydrostatic_balance(*a, ptop=300.0), want,
              BLOCK_RTOL)
    phis = state["surface_geopotential"]
    want = jcr.blending_weight(phis, area, factor)
    for p, a in ((phis, area), (torch.as_tensor(phis),
                                torch.as_tensor(area))):
        close(tcr.blending_weight(p, a, factor), want, BLOCK_RTOL)
    assert (want == 1.0).any() and (want == 0.0).any()
    assert ((want > 0.0) & (want < 1.0)).any()


# ---------------------------------------------------------------- surface


def sfc_data(factor, seed=8):
    """Every variable of the complex method's table, with a land/sea/ice
    mask, vegetation and soil types, and soil columns."""
    rng = np.random.RandomState(seed)
    s = (6, N, N)
    out = {
        "slmsk": rng.randint(0, 3, s).astype(float),
        "vtype": rng.choice([1.0, 7.0, 15.0], s),
        "stype": rng.choice([2.0, 5.0, 9.0], s),
        "vfrac": rng.rand(*s) * (rng.rand(*s) > 0.3),
        "sncovr": rng.rand(*s), "fice": rng.rand(*s),
        "tsea": 270.0 + 10.0 * rng.rand(*s),
        "tg3": 270.0 + 10.0 * rng.rand(*s),
        "canopy": rng.rand(*s), "zorl": rng.rand(*s),
        "smc": rng.rand(6, 4, N, N), "stc": 280.0 + rng.rand(6, 4, N, N),
        "slc": rng.rand(*s), "srflag": rng.randint(0, 2, s).astype(float),
        "slope": rng.randint(1, 4, s).astype(float),
        "sheleg": rng.rand(*s), "hice": rng.rand(*s),
        "shdmin": 0.02 * rng.rand(*s), "shdmax": rng.rand(*s),
        "snoalb": rng.rand(*s), "tisfc": 260.0 + 10.0 * rng.rand(*s),
        "alvsf": rng.rand(*s), "t2m": 280.0 + rng.rand(*s),
        "uustar": rng.rand(*s), "other": rng.rand(*s),
    }
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("factor", FACTORS)
def test_sfc_data_complex(factor, kind):
    sfc = sfc_data(factor)
    area = 1.0 + 0.1 * np.random.RandomState(9).rand(6, N, N)
    want = jcr.coarsen_sfc_data_complex(sfc, area, factor)
    if kind == "tensor":
        sfc = {k: torch.as_tensor(v) for k, v in sfc.items()}
    got = tcr.coarsen_sfc_data_complex(sfc, area, factor)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        close(got[k], want[k], BLOCK_RTOL, k)
    for k in ("slmsk", "vtype", "stype", "srflag", "slope"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("factor", FACTORS)
def test_sfc_data(factor, kind):
    """The dominant-surface-type method: the coarse temperature is the
    dominant type's."""
    rng = np.random.RandomState(factor)
    slmsk = rng.randint(0, 2, (6, N, N)).astype(np.float64)
    sfc = {"slmsk": slmsk, "surface_temperature":
           np.where(slmsk == 1, 300.0, 280.0),
           "vtype": rng.randint(0, 3, (6, N, N)).astype(np.float64)}
    area = 1.0 + 0.1 * rng.rand(6, N, N)
    want = jcr.coarsen_sfc_data(sfc, area, factor)
    if kind == "tensor":
        sfc = {k: torch.as_tensor(v) for k, v in sfc.items()}
        area = torch.as_tensor(area)
    got = tcr.coarsen_sfc_data(sfc, area, factor)
    close_dicts(got, want, BLOCK_RTOL)
    np.testing.assert_array_equal(got["slmsk"], want["slmsk"])


def test_surface_chgres_corrections():
    rng = np.random.RandomState(11)
    ds = {"vtype": rng.choice([1.0, 15.0], (6, 4, 4)),
          "stype": rng.choice([2.0, 5.0], (6, 4, 4)),
          "tsea": 265.0 + 15.0 * rng.rand(6, 4, 4),
          "tg3": 265.0 + 15.0 * rng.rand(6, 4, 4),
          "canopy": rng.rand(6, 4, 4), "shdmin": 0.02 * rng.rand(6, 4, 4)}
    want = jcr.apply_surface_chgres_corrections(ds)
    got = tcr.apply_surface_chgres_corrections(
        {k: torch.as_tensor(v) for k, v in ds.items()})
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------------ budget


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("factor", FACTORS)
def test_budget_ingredients(factor, kind):
    """compute_budget_ingredients with the two default flux pairs: the
    first and second moments on pressure surfaces, the eddy fluxes and
    the exposed area, as tensors on the CPU."""
    state, area = fine_state(factor)
    rng = np.random.RandomState(12)
    fine = {k: state[k] for k in (DELP, "air_temperature",
                                  "specific_humidity")}
    fine["omega"] = rng.randn(6, NZ, N, N)
    delp_c = jco.weighted_block_average(state[DELP], area[:, None], factor)
    want = jfb.compute_budget_ingredients(fine, delp_c, area, factor)
    kw = {"device": "cpu"}
    if kind == "tensor":
        fine = {k: torch.as_tensor(v) for k, v in fine.items()}
        delp_c, area, kw = torch.as_tensor(delp_c), torch.as_tensor(area), {}
    got = tfb.compute_budget_ingredients(fine, delp_c, area, factor, **kw)
    assert all(isinstance(v, torch.Tensor) for v in got.values())
    assert len(got) == 8
    close_dicts(got, want, REMAP_RTOL)
    # the decomposition identity holds in the port's outputs
    np.testing.assert_allclose(
        got["omega_air_temperature"].numpy(),
        (got["omega"] * got["air_temperature"]
         + got["eddy_omega_air_temperature"]).numpy(), rtol=1e-12)


def test_budget_parts_and_device_default():
    """pressure_level_average preserves a constant, exposed_area is the
    whole block area on flat terrain, and host arrays with no device
    need the card."""
    factor = 2
    rng = np.random.RandomState(13)
    delp_f = 1000.0 * (1.0 + 0.05 * rng.rand(6, NZ, N, N))
    delp_c = jco.block_coarsen(delp_f, factor, "mean")
    area = np.ones((6, N, N))
    f = np.full((6, NZ, N, N), 7.5)
    out = tfb.pressure_level_average(f, delp_f, delp_c, area, factor,
                                     device="cpu")
    close(out, jfb.pressure_level_average(f, delp_f, delp_c, area,
                                          factor), REMAP_RTOL)
    np.testing.assert_allclose(out.numpy(), 7.5, rtol=1e-12)
    flat = np.full((6, NZ, N, N), 1000.0)
    ea = tfb.exposed_area(flat, jco.block_coarsen(flat, factor, "mean"),
                          area, factor, device="cpu")
    np.testing.assert_allclose(ea.numpy(), factor * factor, rtol=1e-12)
    assert tfb.storage(1.0, 4.0, 900.0) == jfb.storage(1.0, 4.0, 900.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pressure_level_average"):
            tfb.pressure_level_average(f, delp_f, delp_c, area, factor)
        state, area = fine_state(factor)
        with pytest.raises(RuntimeError, match="on_pressure"):
            tcr.coarsen_restarts_on_pressure(state, area, factor)
