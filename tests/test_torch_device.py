"""The port's entry points run on the CUDA device unless the caller names
another: without a card their default raises a RuntimeError that names
the function (never a silent CPU run), and device="cpu" runs the plain
path.  Whether there is a card is decided inside each test (the card is
hidden with monkeypatch), so the tests run alike with and without one."""

import re

import numpy as np
import pytest
import torch

from fv3net_tpu_torch import convert
from fv3net_tpu_torch.device import default_device
from fv3net_tpu_torch.dycore import hydro, sw
from fv3net_tpu_torch.grid import CubedSphereGrid

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
    "metrics_from_numpy": lambda: convert.metrics_from_numpy({}),
    "state_from_numpy": lambda: convert.state_from_numpy({}),
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
