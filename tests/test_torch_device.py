"""The port's entry points run on the CUDA device unless the caller names
another: without a card their default raises a RuntimeError that names
the function (never a silent CPU run), and device="cpu" runs the plain
path.  Whether there is a card is decided inside each test (the card is
hidden with monkeypatch), so the tests run alike with and without one."""

import re

import numpy as np
import pytest
import torch

from fv3net_tpu_torch import convert, fit, wrapper
from fv3net_tpu_torch.diagnostics import compute, offline
from fv3net_tpu_torch.device import default_device
from fv3net_tpu_torch.fit import reservoir as fit_reservoir
from fv3net_tpu_torch.fit import train as fit_train
from fv3net_tpu_torch.fit import transformed as fit_transformed
from fv3net_tpu_torch.dycore import hydro, sw
from fv3net_tpu_torch.grid import CubedSphereGrid
from fv3net_tpu_torch.regrid import FregridLatLon
from fv3net_tpu_torch.runtime import cli, segmented_run
from fv3net_tpu_torch.utils import (
    coarsen_restarts, fine_res_budget, interpolate)

torch.set_num_threads(1)

n, NZ, PTOP = 6, 4, 300.0


def _grid():
    return CubedSphereGrid.make(n, halo=3)


ENTRY_POINTS = {
    "make_dycore_stepper": lambda: hydro.make_dycore_stepper(
        _grid(), NZ, 900.0),
    "benchmark_state": lambda: hydro.benchmark_state(n, NZ, PTOP),
    "rest_state": lambda: hydro.rest_state(n, NZ, PTOP),
    "SWMetrics.make": lambda: sw.SWMetrics.make(_grid()),
    "make_sw_stepper": lambda: sw.make_sw_stepper(_grid(), 300.0),
    "sw_state_from_numpy": lambda: convert.sw_state_from_numpy({}),
    "FregridLatLon.regrid": lambda: FregridLatLon(_grid(), 6, 12).regrid(
        np.ones((6, n, n))),
    "metrics_from_numpy": lambda: convert.metrics_from_numpy({}),
    "state_from_numpy": lambda: convert.state_from_numpy({}),
    "initialize": lambda: wrapper.initialize(
        wrapper.ModelConfig(npx=n + 1, npz=NZ)),
    "append": lambda: segmented_run.append("no-such-run"),
    "runfv3 append": lambda: cli.main(["append", "no-such-run"]),
    "runfv3 run-native": lambda: cli.main(
        ["run-native", "no-such-config.yml", "no-such-run"]),
    "fit.load": lambda: fit.load("no-such-model"),
    "fit.train": lambda: fit_train.main(
        ["no-such-training.yml", "no-such-data.yml", "no-such-out"]),
    "train_dense_model": lambda: fit.train_dense_model(
        fit.DenseHyperparameters(), []),
    "train_precipitative_model": lambda: fit.train_precipitative_model(
        fit.PrecipitativeHyperparameters(), [],
        input_variables=["pressure_thickness_of_atmospheric_layer"]),
    "train_convolutional_model": lambda: fit.train_convolutional_model(
        fit.ConvolutionalHyperparameters(), []),
    "train_transformed": lambda: fit.train_transformed(
        fit_transformed.TransformedParameters(), []),
    "train_reservoir_model": lambda: fit.train_reservoir_model(
        fit.ReservoirHyperparameters(), []),
    "Reservoir": lambda: fit_reservoir.Reservoir(
        fit.ReservoirHyperparameters(), 3),
    "train_fmr_model": lambda: fit.train_fmr_model(
        fit.FMRHyperparameters(), []),
    "train_graph_model": lambda: fit.train_graph_model(
        fit.GraphHyperparameters(), []),
    "train_autoencoder": lambda: fit.train_autoencoder(
        fit.AutoencoderHyperparameters(), []),
    "train_cyclegan": lambda: fit.train_cyclegan(
        fit.CycleGANHyperparameters(), []),
    "diagnostics.offline.evaluate": lambda: offline.evaluate(
        "no-such-model", {}, {}, "no-such-output"),
    "compute_diagnostics": lambda: compute.compute_diagnostics({}),
    "interpolate_1d": lambda: interpolate.interpolate_1d(
        np.ones((2, 3)), np.ones((4, 3)), np.ones((4, 3)), axis=0),
    "coarsen_restarts_on_pressure":
        lambda: coarsen_restarts.coarsen_restarts_on_pressure(
            {"pressure_thickness_of_atmospheric_layer": np.ones(
                (6, NZ, n, n))}, np.ones((6, n, n)), 2),
    "pressure_level_average": lambda: fine_res_budget.pressure_level_average(
        np.ones((6, NZ, n, n)), np.ones((6, NZ, n, n)),
        np.ones((6, NZ, n // 2, n // 2)), np.ones((6, n, n)), 2),
    "exposed_area": lambda: fine_res_budget.exposed_area(
        np.ones((6, NZ, n, n)), np.ones((6, NZ, n // 2, n // 2)),
        np.ones((6, n, n)), 2),
    "compute_budget_ingredients":
        lambda: fine_res_budget.compute_budget_ingredients(
            {}, np.ones((6, NZ, n // 2, n // 2)), np.ones((6, n, n)), 2),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError,
                       match=rf'^{re.escape(name)} .*device="cpu"'):
        ENTRY_POINTS[name]()


def test_default_device_is_the_card_where_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device("make_dycore_stepper") == torch.device("cuda")


def test_explicit_cpu_runs_the_plain_path(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run, m, (ak, bk) = hydro.make_dycore_stepper(
        _grid(), NZ, 900.0, dtype=torch.float64, device="cpu",
    )
    st = hydro.benchmark_state(n, NZ, PTOP, device="cpu")
    st = type(st)(*(x.double() for x in st))
    out = run(st, torch.zeros(6, n, n, dtype=torch.float64), 1)
    for k, x in out._asdict().items():
        assert x.device.type == "cpu", k
        assert bool(torch.isfinite(x).all()), k
    assert m.area_px.device.type == "cpu" and ak.device.type == "cpu"
    rest = hydro.rest_state(n, NZ, PTOP, device="cpu")
    assert rest.delp.device.type == "cpu"
    back = convert.state_from_numpy(convert.state_to_numpy(out), "cpu")
    for a, b in zip(back, out):
        assert torch.equal(a, b)
    arrays = {f: getattr(m, f) for f in ("n", "halo", "divdamp_scale")}
    arrays.update({
        f: np.asarray(v) for f, v in vars(m).items()
        if isinstance(v, torch.Tensor)
    })
    m2 = convert.metrics_from_numpy(arrays, "cpu")
    assert torch.equal(m2.area_px, m.area_px)
    assert m2.area_px.device.type == "cpu"


def test_initialize_on_explicit_cpu_steps_every_phase(monkeypatch):
    """wrapper.initialize(device="cpu") builds the default (hydrostatic,
    simple suite) model on the CPU, and every phase of a step keeps it
    there; the Held-Suarez configuration likewise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"do_held_suarez": True, "physics_suite": "none"}):
        wrapper.initialize(
            wrapper.ModelConfig(npx=n + 1, npz=NZ, dtype="float64", **kw),
            device="cpu",
        )
        mdl = wrapper.get_model()
        assert mdl.config.hydrostatic and mdl.state.w is None
        for phase in (wrapper.step_dynamics, wrapper.step_pre_radiation,
                      wrapper.step_radiation,
                      wrapper.step_post_radiation_physics,
                      wrapper.apply_physics):
            phase()
        for k, x in mdl.state._asdict().items():
            if x is not None:
                assert x.device.type == "cpu", k
                assert bool(torch.isfinite(x).all()), k
        assert mdl.total_precip.device.type == "cpu"
        assert wrapper.get_step_count() == 1
