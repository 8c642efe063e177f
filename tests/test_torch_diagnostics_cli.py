"""The port's ``prognostic_run_diags`` CLI (``diagnostics.cli``) against
the JAX package's on one zarr-lite run store (and a verification store):
``compute`` (equal ``diags.npz`` and ``metrics.json``), ``metrics``,
``report``, ``movies`` (the same frames), ``log-viewer`` and
``single-run``, and ``--help`` listing every subcommand.

Tolerance: the CLI's groups are host numpy in both packages (its grid
carries no delp, so no group interpolates), so every output is equal;
the HTML pages are equal but for their time stamps."""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from fv3net_tpu.diagnostics import cli as jcli
from fv3net_tpu_torch.diagnostics import cli as tcli
from fv3net_tpu_torch.io.zarr_lite import ZarrLiteStore

torch.set_num_threads(1)

N, NZ, NT = 12, 4, 26


def write_run(path, seed):
    rng = np.random.RandomState(seed)
    store = ZarrLiteStore(str(path))
    fields = {
        "surface_pressure": 1e5 + 50 * rng.randn(NT, 6, N, N),
        "total_precipitation_rate": np.abs(1e-5 * rng.randn(NT, 6, N, N)),
        "air_temperature": 250 + 30 * rng.rand(NT, 6, NZ, N, N),
    }
    for name, arr in fields.items():
        arr = arr.astype(np.float32)
        dims = ("time", "tile", "y", "x") if arr.ndim == 4 else (
            "time", "tile", "z", "y", "x")
        store.create_array(name, shape=arr.shape,
                           chunks=(1,) + arr.shape[1:], dtype=np.float32,
                           dims=dims)
        store.write_full(name, arr)
    return str(path)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    return (write_run(root / "run.zarr", 0),
            write_run(root / "verification.zarr", 1))


def page(path):
    return re.sub(r"created \S+", "", open(path).read())


@pytest.fixture(scope="module")
def computed(stores, tmp_path_factory):
    run, ver = stores
    out = tmp_path_factory.mktemp("diags")
    dirs = (str(out / "jax"), str(out / "torch"))
    assert jcli.main(["compute", run, "-o", dirs[0], "--verification",
                      ver]) == 0
    assert tcli.main(["compute", run, "-o", dirs[1], "--verification",
                      ver, "--device", "cpu"]) == 0
    return dirs


def test_compute(computed):
    jdir, tdir = computed
    want = np.load(os.path.join(jdir, "diags.npz"))
    got = np.load(os.path.join(tdir, "diags.npz"))
    assert sorted(got.files) == sorted(want.files) and len(got.files) > 40
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
    metrics = [json.load(open(os.path.join(d, "metrics.json")))
               for d in computed]
    assert metrics[1] == metrics[0] and metrics[1]


def test_metrics(computed, capsys):
    printed = []
    for mod, d in zip((jcli, tcli), computed):
        assert mod.main(["metrics", os.path.join(d, "diags.npz")]) == 0
        printed.append(json.loads(capsys.readouterr().out))
    assert printed[1] == printed[0]


def test_report(stores, tmp_path):
    run, _ = stores
    assert jcli.main(["report", run, "-o", str(tmp_path / "j")]) == 0
    assert tcli.main(["report", run, "-o", str(tmp_path / "t"),
                      "--device", "cpu"]) == 0
    pages = [page(tmp_path / d / "index.html") for d in "jt"]
    assert pages[1] == pages[0] and "Metrics" in pages[1]


def test_movies(stores, tmp_path):
    run, _ = stores
    frames = []
    for mod, d in ((jcli, "j"), (tcli, "t")):
        assert mod.main(["movies", run, "-o", str(tmp_path / d),
                         "--variables", "surface_pressure",
                         "total_precipitation_rate",
                         "--max-frames", "3"]) == 0
        frames.append({
            v: sorted(os.listdir(tmp_path / d / "movies" / v))
            for v in ("surface_pressure", "total_precipitation_rate")})
    assert frames[1] == frames[0]
    assert frames[1]["surface_pressure"] == [
        f"frame_{t:04d}.png" for t in range(3)]


def test_movies_needs_matplotlib(stores, tmp_path, monkeypatch):
    """Without matplotlib the renders raise ImportError (the package and
    the CLI import without it)."""
    for name in [m for m in sys.modules if m.startswith("matplotlib")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        tcli.movies_cmd(stores[0], str(tmp_path), max_frames=1)
    from fv3net_tpu_torch.viz import plot_cube

    with pytest.raises(ImportError):
        plot_cube(np.zeros((6, N, N)))


def test_log_viewer(tmp_path):
    from fv3net_tpu_torch.runtime.timing import ScalarSink

    seg = tmp_path / "run" / "segments" / "0000"
    os.makedirs(seg)
    sink = ScalarSink(str(seg))
    for step in range(5):
        sink.write(step, f"t{step}", {"mass": 1.0 + step, "te": 2.0})
    sink.close()
    with open(seg / "timing.json", "w") as f:
        json.dump({"dynamics": {"min": 0.1, "max": 0.2, "mean": 0.15}}, f)
    pages = [page(mod.log_viewer_cmd(str(tmp_path / "run"),
                                     str(tmp_path / d)))
             for mod, d in ((jcli, "j"), (tcli, "t"))]
    assert pages[1] == pages[0]
    assert "mass" in pages[1] and "dynamics" in pages[1] and "svg" in pages[1]


def test_single_run(tmp_path):
    rng = np.random.RandomState(1)
    z = ZarrLiteStore(str(tmp_path / "state_output.zarr"))
    t_in = 280.0 + rng.randn(4, 8)
    t_after = t_in + 0.1 * rng.randn(4, 8)
    for name, arr in (("air_temperature_input", t_in),
                      ("air_temperature_after_precpd", t_after),
                      ("air_temperature_output",
                       t_after + 0.01 * rng.randn(4, 8))):
        z.create_array(name, arr.shape, (1, 8), arr.dtype)
        z.write_full(name, arr)
    got = [mod.single_run_cmd(str(tmp_path), str(tmp_path / d))
           for mod, d in ((jcli, "j"), (tcli, "t"))]
    assert got[1] == got[0] and got[1]["air_temperature/emulator_r2"] > 0.9
    assert json.load(open(tmp_path / "t" / "single_run.json")) == got[1]
    assert page(tmp_path / "t" / "single_run.html") == page(
        tmp_path / "j" / "single_run.html")


def test_help_lists_every_subcommand(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    out = capsys.readouterr().out
    for cmd in ("compute", "metrics", "report", "movies", "offline",
                "log-viewer", "single-run", "shell"):
        assert cmd in out
    for cmd in ("compute", "report", "offline"):
        with pytest.raises(SystemExit):
            tcli.main([cmd, "--help"])
        assert "--device" in capsys.readouterr().out
