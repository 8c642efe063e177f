"""The port's offline evaluation of a trained model against the JAX
package's ``diagnostics.offline`` and its ``offline`` CLI, on dumps that
both packages load (a dense model and a graph model trained and dumped by
the JAX package), over a mapper of seeded states.

Tolerances.  The reductions are the same numpy code: on the same
predictions they agree bit for bit.  The models predict in float32 in
both packages (PRED_RTOL 1e-5 of each output, as the fit tests;
measured <= 1.4e-6), and the metrics computed from them agree to
METRIC_RTOL of each metric's magnitude (measured: <= 2.9e-7).  The
column Jacobian is a central difference at rel_eps 1e-3 of float32
predictions, so each package's float32 Jacobian differs from the float64
one (the same network in float64) by ~1e-5 to 1e-4 of its scale:
measured 1.8e-5 (port) and 2.6e-5 (JAX), the two packages' 2.8e-5 apart.
The port's Jacobian is held to F32_FACTOR 3 times its own float32 spread
from the JAX package's."""

import copy
import json

import numpy as np
import pytest
import torch
import yaml

import fv3net_tpu.fit as jfit
from fv3net_tpu.data import SyntheticWaves
from fv3net_tpu.diagnostics import offline as joff
from fv3net_tpu.io.zarr_lite import ZarrLiteStore
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch.diagnostics import offline as toff
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from torch_parity import assert_close_scaled

torch.set_num_threads(1)

NT, NZ, N = 3, 5, 6
PRED_RTOL = 1e-5
METRIC_RTOL = 1e-5
F32_FACTOR = 3.0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """JAX dumps of a dense and a graph model, and the batches."""
    batches = SyntheticWaves(["a_in", "b_out"], n=N, nz=NZ, nbatch=NT,
                             seed=1).batches()
    kw = dict(input_variables=["a_in"], output_variables=["b_out"])
    root = tmp_path_factory.mktemp("models")
    paths = {}
    for name, model in (
            ("dense", jfit.train_dense_model(
                jfit.DenseHyperparameters(depth=2, width=32, epochs=20),
                batches, **kw)),
            ("graph", jfit.train_graph_model(
                jfit.GraphHyperparameters(width=8, depth=2, epochs=20),
                batches, **kw))):
        paths[name] = str(root / name)
        jfit.dump(model, paths[name])
    return paths, batches


def _mapper(batches, port):
    wrap = (lambda b: {k: TQuantity(np.asarray(q.data), q.dims, q.units)
                       for k, q in b.items()}) if port else dict
    return {f"2016080{i + 1}.000000": wrap(b) for i, b in enumerate(batches)}


def _grid():
    from fv3net_tpu_torch.grid import CubedSphereGrid

    g = CubedSphereGrid.make(N, halo=3)
    sl = g.interior
    return {k: np.asarray(getattr(g, k)[sl]) for k in ("area", "lat", "lon")}


@pytest.mark.parametrize("name", ["dense", "graph"])
def test_predict_and_reduce_match_jax(trained, name):
    """predict_over_mapper: the port's predictions against the JAX
    package's, the targets and times equal; compute_offline_diagnostics:
    on the same predictions equal bit for bit, on each package's own
    within METRIC_RTOL."""
    paths, batches = trained
    jm, tm = jfit.load(paths[name]), tfit.load(paths[name], "cpu")
    jp, jt, jx = joff.predict_over_mapper(jm, _mapper(batches, False))
    tp, tt, tx = toff.predict_over_mapper(tm, _mapper(batches, True))
    assert tp["b_out"].shape == (NT, 6, NZ, N, N)
    assert tx["times"] == jx["times"]
    np.testing.assert_array_equal(tt["b_out"], jt["b_out"])
    assert_close_scaled(tp["b_out"], jp["b_out"], PRED_RTOL, "prediction")
    grid = _grid()
    d_same, m_same = toff.compute_offline_diagnostics(jp, jt, grid, jx)
    d_want, m_want = joff.compute_offline_diagnostics(jp, jt, grid, jx)
    assert sorted(d_same) == sorted(d_want)
    for k in d_want:
        np.testing.assert_array_equal(d_same[k], d_want[k])
    assert m_same == m_want
    _, m_got = toff.compute_offline_diagnostics(tp, tt, grid, tx)
    assert sorted(m_got) == sorted(m_want)
    for k, v in m_want.items():
        assert abs(m_got[k] - v) <= METRIC_RTOL * abs(v), (k, m_got[k], v)


class _Float64Dense:
    """The port's dense model with its network in float64 (the float64
    reference of the float32 Jacobian)."""

    def __init__(self, model):
        self.model = model
        self.input_variables = model.input_variables
        self.output_variables = model.output_variables
        self.module = copy.deepcopy(model.module).double()

    def predict(self, X):
        m = self.model
        x = m.scaler_in.normalize(m.packer_in.to_array(X).astype(np.float64))
        with torch.no_grad():
            yn = self.module(torch.as_tensor(x)).numpy()
        return m.packer_out.to_state(m.scaler_out.denormalize(yn),
                                     m._templates(X))


def test_column_jacobian_matches_jax_within_f32_spread(trained):
    """The dense model's column Jacobian in the port against the JAX
    package's, held by the port's own float32-vs-float64 spread (module
    docstring)."""
    paths, batches = trained
    jm, tm = jfit.load(paths["dense"]), tfit.load(paths["dense"], "cpu")
    sample = _mapper(batches, True)["20160801.000000"]
    got = toff.column_jacobian(tm, sample)
    ref = toff.column_jacobian(_Float64Dense(tm), sample)
    want = joff.column_jacobian(jm, batches[0])
    assert sorted(got) == sorted(want) == ["b_out/a_in"]
    k = "b_out/a_in"
    assert got[k].shape == (NZ, NZ)
    scale = np.abs(ref[k]).max()
    spread = np.abs(got[k] - ref[k]).max()
    assert 0 < spread <= 1e-3 * scale, spread / scale
    assert np.abs(want[k] - ref[k]).max() <= 1e-3 * scale
    assert np.abs(got[k] - want[k]).max() <= F32_FACTOR * spread


@pytest.fixture(scope="module")
def store(tmp_path_factory, trained):
    """A zarr-lite store of the batches' input and target."""
    _, batches = trained
    path = str(tmp_path_factory.mktemp("run") / "test_data.zarr")
    st = ZarrLiteStore(path)
    for v in ("a_in", "b_out"):
        data = np.stack([np.asarray(b[v].values) for b in batches]).astype(
            np.float32)
        st.create_array(v, shape=data.shape, chunks=(1,) + data.shape[1:],
                        dtype=np.float32,
                        dims=("time", "tile", "z", "y", "x"))
        st.write_full(v, data)
    return path


@pytest.mark.parametrize("name", ["dense", "graph"])
def test_offline_cli_matches_jax(tmp_path, trained, store, name, capsys):
    """Both packages' ``offline`` subcommand on the same dump and mapper
    YAML (the port with --device cpu): the same scalar metrics within
    METRIC_RTOL, the diagnostics file, the report and, for the column
    model, the Jacobians; the graph model has none (its predict needs
    whole cubes, so the JAX package's evaluate skips it, and so does the
    port's)."""
    from fv3net_tpu.diagnostics.cli import main as jmain
    from fv3net_tpu_torch.diagnostics.cli import main as tmain

    paths, _ = trained
    spec = tmp_path / "data.yaml"
    spec.write_text(yaml.safe_dump({"mapper_function": "open_zarr",
                                    "mapper_kwargs": {"path": store}}))
    out = {}
    for pkg, main, extra in (("jax", jmain, []),
                             ("port", tmain, ["--device", "cpu"])):
        out[pkg] = tmp_path / pkg
        assert main(["offline", paths[name], str(spec), "-o",
                     str(out[pkg])] + extra) == 0
        assert (out[pkg] / "index.html").exists()
        assert (out[pkg] / "offline_diagnostics.npz").exists()
        assert (out[pkg] / "jacobians.npz").exists() == (name == "dense")
    printed = json.loads(capsys.readouterr().out.split("\n}\n")[-2] + "\n}")
    metrics = {pkg: json.loads((out[pkg] / "scalar_metrics.json").read_text())
               for pkg in out}
    assert printed == metrics["port"]
    assert sorted(metrics["port"]) == sorted(metrics["jax"])
    assert "b_out_r2_global" in metrics["port"]
    for k, v in metrics["jax"].items():
        assert abs(metrics["port"][k] - v) <= METRIC_RTOL * abs(v), k
    html = (out["port"] / "index.html").read_text()
    assert ("Jacobians" in html) == (name == "dense") and "b_out" in html
