"""The training-data layer of fv3net_tpu_torch (``data/``, copied from the
JAX package) against the JAX package's: the cases of tests/test_mappers.py
and tests/test_serialized_batches.py (the capture store written by the
JAX package's StorageHook) and the other batch sources, sequences and
schemas, run on both packages from the same files with equal outputs."""

import numpy as np
import pytest

from fv3net_tpu import data as jdata
from fv3net_tpu.data import batches as jbatches
from fv3net_tpu.data import synth as jsynth
from fv3net_tpu.emulation.hooks import StorageHook
from fv3net_tpu.io import netcdf3
from fv3net_tpu.io.zarr_lite import ZarrLiteStore
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch import data as tdata
from fv3net_tpu_torch.data import batches as tbatches
from fv3net_tpu_torch.data import synth as tsynth
from fv3net_tpu_torch.util.quantity import Quantity

NT, NZ, N = 3, 4, 6
DIMS = ("time", "tile", "z", "y", "x")
PKGS = {"jax": jdata, "torch": tdata}


def _write_store(path, variables, seed=0):
    store = ZarrLiteStore(str(path))
    rng = np.random.RandomState(seed)
    shape = (NT, 6, NZ, N, N)
    for v in variables:
        store.create_array(v, shape=shape, chunks=(1,) + shape[1:],
                           dtype=np.float32, dims=DIMS)
        store.write_full(v, rng.randn(*shape).astype(np.float32))
    return store


@pytest.fixture()
def nudged_run(tmp_path):
    run = tmp_path / "nudged_run"
    run.mkdir()
    _write_store(run / "state_after_timestep.zarr",
                 ["air_temperature", "specific_humidity"], seed=1)
    _write_store(run / "nudging_tendencies.zarr",
                 ["air_temperature_tendency_due_to_nudging",
                  "specific_humidity_tendency_due_to_nudging"], seed=2)
    return str(run)


def _same_states(got, want):
    """Two State dicts (or lists of them): equal names, dims and values."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_states(g, w)
        return
    assert list(got) == list(want)
    for k, w in want.items():
        assert isinstance(got[k], Quantity), k
        assert got[k].dims == w.dims and got[k].units == w.units, k
        np.testing.assert_array_equal(got[k].values, w.values, k)


def _same_mappers(got, want):
    assert list(got.keys()) == list(want.keys())
    for key in want.keys():
        _same_states(got[key], want[key])


def test_open_nudge_to_fine_renames(nudged_run):
    mappers = {p: m.open_nudge_to_fine(nudged_run) for p, m in PKGS.items()}
    _same_mappers(mappers["torch"], mappers["jax"])
    mapper = mappers["torch"]
    assert len(mapper) == NT
    state = mapper[sorted(mapper.keys())[0]]
    assert {"dQ1", "dQ2", "air_temperature"} <= set(state)
    assert state["dQ1"].shape == (6, NZ, N, N)


def test_open_nudge_to_fine_multiple_and_to_obs(nudged_run):
    for fn in ("open_nudge_to_fine_multiple_datasets",):
        got = getattr(tdata, fn)([nudged_run, nudged_run])
        _same_mappers(got, getattr(jdata, fn)([nudged_run, nudged_run]))
        assert len(got) == 2 * NT
    got = tdata.open_nudge_to_obs(nudged_run)
    _same_mappers(got, jdata.open_nudge_to_obs(nudged_run))
    assert len(got) == NT


def test_mapper_registry_and_config(nudged_run):
    assert sorted(tdata.mapper_functions) == sorted(jdata.mapper_functions)
    got = tdata.MapperConfig("open_nudge_to_fine",
                             {"url": nudged_run}).open_mapper()
    want = jdata.MapperConfig("open_nudge_to_fine",
                              {"url": nudged_run}).open_mapper()
    _same_mappers(got, want)
    assert len(got) == NT


@pytest.mark.parametrize("kw", [
    dict(variable_names=["air_temperature", "dQ1"]),
    dict(variable_names=["dQ1"], timesteps_per_batch=3),
    dict(variable_names=["dQ1"], shuffle_seed=7),
    dict(variable_names=["dQ1", "dQ2"], timesteps_per_batch=2,
         shuffle_seed=3),
])
def test_batches_from_mapper(nudged_run, kw):
    got = tdata.batches_from_mapper("open_nudge_to_fine",
                                    {"url": nudged_run}, **kw)
    want = jdata.batches_from_mapper("open_nudge_to_fine",
                                     {"url": nudged_run}, **kw)
    _same_states(got, want)
    per = kw.get("timesteps_per_batch", 1)
    assert len(got) == -(-NT // per)
    assert set(got[0]) == set(kw["variable_names"])
    if per == 3:
        assert got[0]["dQ1"].shape == (18, NZ, N, N)
    again = tdata.BatchesFromMapperConfig(
        tdata.MapperConfig("open_nudge_to_fine", {"url": nudged_run}),
        **kw).load_batches()
    _same_states(again, got)


def test_open_fine_resolution_apparent_sources(tmp_path):
    path = tmp_path / "budget.zarr"
    _write_store(path, [
        f"{v}_tendency_due_to_{kind}"
        for v in ("T", "sphum")
        for kind in ("dynamics_fine", "dynamics_coarse", "physics_fine")
    ], seed=3)
    got = tdata.open_fine_resolution(str(path))
    _same_mappers(got, jdata.open_fine_resolution(str(path)))
    state = got[sorted(got.keys())[0]]
    np.testing.assert_allclose(
        state["Q1"].values,
        state["T_tendency_due_to_dynamics_fine"].values
        - state["T_tendency_due_to_dynamics_coarse"].values
        + state["T_tendency_due_to_physics_fine"].values)
    assert "Q2" in state


def _capture(path, n_savepoints=3):
    """The JAX package's StorageHook fed synthetic physics states, the
    way its wrapper's apply_physics feeds it
    (tests/test_serialized_batches.py)."""
    hook = StorageHook(str(path), output_freq_sec=900, dt_sec=900)
    rng = np.random.RandomState(0)
    for _ in range(n_savepoints):
        t = 250.0 + 10.0 * rng.rand(6, 5, 4, 4)
        hook.store({
            "air_temperature_input": t.astype(np.float32),
            "specific_humidity_input":
                (1e-3 * rng.rand(6, 5, 4, 4)).astype(np.float32),
            "air_temperature_after_gscond":
                (t + 0.1 * rng.randn(6, 5, 4, 4)).astype(np.float32),
            "surface_air_pressure":
                (1e5 + rng.randn(6, 4, 4)).astype(np.float32),
            "time": "20160801.000000",  # non-numeric: not captured
        })
    return str(path)


@pytest.mark.parametrize("savepoints, per_batch", [(3, 1), (4, 2)])
def test_batches_from_serialized(tmp_path, savepoints, per_batch):
    assert "batches_from_serialized" in tbatches.batches_functions
    path = _capture(tmp_path, savepoints)
    got = tbatches.batches_from_serialized(
        path, savepoints_per_batch=per_batch)
    want = jbatches.batches_from_serialized(
        path, savepoints_per_batch=per_batch)
    _same_states(got, want)
    assert len(got) == savepoints // per_batch
    b = got[0]
    assert "time" not in b
    assert b["air_temperature_input"].values.shape == (per_batch * 96, 5)
    assert b["surface_air_pressure"].values.shape == (per_batch * 96, 1)


def test_batches_from_zarr_and_netcdf(tmp_path, nudged_run):
    url = nudged_run + "/state_after_timestep.zarr"
    args = (url, ["air_temperature", "specific_humidity"])
    _same_states(tbatches.batches_from_zarr(*args),
                 jbatches.batches_from_zarr(*args))
    rng = np.random.RandomState(4)
    for i in range(3):
        netcdf3.write(str(tmp_path / f"f{i}.nc"), netcdf3.Dataset(
            {"sample": 5, "z": 3},
            {"a": netcdf3.Variable(rng.randn(5, 3), ("sample", "z"),
                                   {"units": "K"}),
             "b": netcdf3.Variable(rng.randn(5), ("sample",), {})},
            {}))
    for kw in (dict(), dict(sort_files=True), dict(nfiles=2, seed=3)):
        got = tbatches.batches_from_netcdf(str(tmp_path), ["a", "b"], **kw)
        want = jbatches.batches_from_netcdf(str(tmp_path), ["a", "b"], **kw)
        _same_states(got, want)


def test_synthetic_batches_and_registry():
    assert sorted(tbatches.batches_functions) == sorted(
        jbatches.batches_functions)
    for cls in ("SyntheticWaves", "SyntheticNoise"):
        got = getattr(tdata, cls)(["a", "b"], n=4, nz=3, nbatch=2,
                                  seed=1).batches()
        want = getattr(jdata, cls)(["a", "b"], n=4, nz=3, nbatch=2,
                                   seed=1).batches()
        _same_states(got, want)
    cfg = {"function": "synthetic_waves",
           "kwargs": {"variables": ["a"], "n": 4, "nz": 3, "nbatch": 2}}
    _same_states(tdata.open_batches_from_config(cfg),
                 jdata.open_batches_from_config(cfg))


def test_sequences(tmp_path):
    seq = [{"x": i} for i in range(5)]
    for name, pkg in PKGS.items():
        m = pkg.Map(lambda d: d["x"] * 2, seq)
        assert list(m) == [0, 2, 4, 6, 8] and len(m) == 5
        loc = pkg.to_local(seq, str(tmp_path / name))
        assert [loc[i] for i in range(len(loc))] == seq
    assert [d for d in tdata.shuffle(seq, seed=3)] == [
        d for d in jdata.shuffle(seq, seed=3)]
    assert [d for d in tdata.Local(str(tmp_path / "jax"))] == seq


def test_synth_schema_roundtrip(tmp_path):
    state = {
        "air_temperature": np.zeros((2, 6, 3, 4, 4), np.float32),
        "land_sea_mask": np.zeros((6, 4, 4), np.float32),
        "z": np.arange(3.0),
    }
    dims = {"air_temperature": DIMS, "land_sea_mask": ("tile", "y", "x"),
            "z": ("z",)}
    ranges = {"air_temperature": tsynth.Range(200, 300)}
    out = {}
    for name, (synth, Q) in {"jax": (jsynth, JQuantity),
                             "torch": (tsynth, Quantity)}.items():
        schema = synth.read_schema_from_state(
            {k: Q(v, dims[k], "K") for k, v in state.items()})
        path = str(tmp_path / f"{name}.json")
        synth.dump_schema(schema, path)
        out[name] = (open(path).read(), synth.generate(
            synth.load_schema(path), ranges=ranges, seed=1))
    assert out["torch"][0] == out["jax"][0]
    _same_states(out["torch"][1], out["jax"][1])
    t = out["torch"][1]["air_temperature"]
    assert 200 <= t.values.min() and t.values.max() <= 300
    store = ZarrLiteStore(str(tmp_path / "s.zarr"))
    store.create_array("q", shape=(3, 6, 4, 4), chunks=(1, 6, 4, 4),
                       dtype=np.float32, dims=("time", "tile", "y", "x"))
    store.write_full("q", np.ones((3, 6, 4, 4), np.float32))
    got = tsynth.generate(tsynth.read_schema_from_zarr(
        str(tmp_path / "s.zarr")), seed=0)
    want = jsynth.generate(jsynth.read_schema_from_zarr(
        str(tmp_path / "s.zarr")), seed=0)
    _same_states(got, want)
    assert got["q"].shape == (3, 6, 4, 4)
