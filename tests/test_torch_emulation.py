"""The port's emulation package (fv3net_tpu_torch.emulation) and its
transformed training family against the JAX package's: every transform
forward and backward on numpy arrays and on torch tensors (against
jax.numpy arrays), a ComposedTransform built from the same YAML spec,
masks and hooks, ``train_transformed`` from the same initial parameters,
and one emulated ``apply_physics`` at C6 x 8 with the same dumped model.

Tolerances.  The transforms run in float64: ATOL_F64 1e-12 of each
array's magnitude (they are the same formulas; numpy and torch differ
only in the last bits of log/exp).  Training runs in float32: one step
within 1e-6 of each array's magnitude, predictions within PRED_RTOL 1e-5.
The physics step is float64: without an emulator the packages agree to
1e-12 of each field; with one, the float32 network's outputs differ by
its roundoff, so each field agrees to EMU_RTOL 1e-4 of the emulator's
effect on it (max|emulated - physics' own|; measured 5e-6: the
emulator, trained on other columns, sees inputs far out of its training
range and amplifies its roundoff)."""

import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import fv3net_tpu.emulation as jemu
import fv3net_tpu.fit.transformed as jtr_fit
from fv3net_tpu import fit as jfit
from fv3net_tpu.emulation import transforms as jtr
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch import emulation as temu
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch.emulation import gscond
from fv3net_tpu_torch.emulation import transforms as ttr
from fv3net_tpu_torch.fit import transformed as ttr_fit
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from test_transformed_training import _synthetic_gscond_batch, _train_config
from torch_parity import assert_close_scaled, assert_params_close, use_jax_init

torch.set_num_threads(1)

ATOL_F64 = 1e-12
STEP_RTOL = 1e-6
PRED_RTOL = 1e-5
EMU_RTOL = 1e-4


def _close(got, want, name=""):
    """got (numpy or torch) against want (numpy or jax) in float64."""
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= ATOL_F64 * scale, f"{name}: {err:.3e} > {ATOL_F64} * {scale}"


def _dicts_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)


def _each_kind(x):
    """The same float64 dict as numpy (for both packages), and as torch
    tensors (port) beside jax.numpy arrays (JAX package)."""
    return [
        ({k: np.array(v) for k, v in x.items()},
         {k: np.array(v) for k, v in x.items()}),
        ({k: torch.as_tensor(v) for k, v in x.items()},
         {k: jnp.asarray(v) for k, v in x.items()}),
    ]


def _gscond_sample(n=600, nz=4, seed=0):
    b = _synthetic_gscond_batch(n=n, nz=nz, seed=seed)
    out = {k: v.astype(np.float64) for k, v in b.items()}
    # some zero-tendency and zero-cloud cases for the classes
    out[jtr.CLOUD_GSCOND][::5] = out[jtr.CLOUD_INPUT][::5]
    out[jtr.CLOUD_GSCOND][1::7] = 0.0
    out["air_pressure"] = np.linspace(2e4, 1e5, nz)[None] * np.ones((n, 1))
    return out


def _pairs():
    """(port transform, JAX transform) for each single transform."""
    kw = dict(to="scaled", source=jtr.QV_GSCOND, condition_on=jtr.T_INPUT,
              bins=7)
    return {
        "log": (ttr.TransformedVariableConfig(
            jtr.CLOUD_INPUT, "log_cloud", ttr.LogTransform(1e-10)),
            jtr.TransformedVariableConfig(
                jtr.CLOUD_INPUT, "log_cloud", jtr.LogTransform(1e-10))),
        "limit": (ttr.TransformedVariableConfig(
            jtr.CLOUD_GSCOND, "lim", ttr.LimitValueTransform(0.0, 5e-5)),
            jtr.TransformedVariableConfig(
                jtr.CLOUD_GSCOND, "lim", jtr.LimitValueTransform(0.0, 5e-5))),
        "difference": (ttr.Difference("tdiff", jtr.T_INPUT, jtr.T_GSCOND),
                       jtr.Difference("tdiff", jtr.T_INPUT, jtr.T_GSCOND)),
        "conditionally_scaled": (ttr.ConditionallyScaled(**kw),
                                 jtr.ConditionallyScaled(**kw)),
        "one_hot": (ttr.MicrophysicsClassesV1OneHot(),
                    jtr.MicrophysicsClassesV1OneHot()),
        "route": (ttr.GscondClassesRoute(), jtr.GscondClassesRoute()),
        "limiter": (ttr.CloudLimiter(), jtr.CloudLimiter()),
        "relative_humidity": (ttr.RelativeHumidityTransform(),
                              jtr.RelativeHumidityTransform()),
    }


@pytest.mark.parametrize("kind", sorted(_pairs()))
def test_transform_matches_jax(kind):
    """forward, backward and backward_names of each transform, built on
    the same sample, on numpy arrays and on tensors."""
    tt, jt = _pairs()[kind]
    sample = _gscond_sample()
    tt, jt = tt.build(dict(sample)) if hasattr(tt, "build") else tt, (
        jt.build(dict(sample)) if hasattr(jt, "build") else jt)
    if kind == "conditionally_scaled":
        for k, v in jt.params().items():
            np.testing.assert_array_equal(tt.params()[k], v)
    y = dict(sample)
    y["gscond_classes"] = np.random.RandomState(3).rand(len(
        sample[jtr.T_INPUT]), 4, 4)
    y[jtr.CLOUD_GSCOND] = y[jtr.CLOUD_GSCOND] - 2e-5  # negative cloud
    y["log_cloud"] = np.log(sample[jtr.CLOUD_INPUT] + 1e-10)
    y["lim"] = sample[jtr.CLOUD_GSCOND] - 2e-5
    y["tdiff"] = sample[jtr.T_GSCOND] - sample[jtr.T_INPUT]
    y["scaled"] = np.random.RandomState(4).randn(*y["tdiff"].shape)
    for (tx, jx), (ty, jy) in zip(_each_kind(sample), _each_kind(y)):
        for fn in ("forward", "backward"):
            if hasattr(tt, fn):
                args_t, args_j = (tx, jx) if fn == "forward" else (ty, jy)
                _dicts_close(getattr(tt, fn)(dict(args_t)),
                             getattr(jt, fn)(dict(args_j)))
    for req in ({jtr.T_GSCOND}, {jtr.CLOUD_GSCOND}, {"log_cloud"},
                {jtr.QV_GSCOND, "relative_humidity"}, {"gscond_classes"}):
        if hasattr(jt, "backward_names"):
            assert tt.backward_names(set(req)) == jt.backward_names(set(req))


def test_univariate_transforms_and_classify_match_jax():
    rng = np.random.RandomState(5)
    x = np.concatenate([np.abs(rng.randn(50)) * 1e-4, np.zeros(5),
                        -np.abs(rng.randn(5)) * 1e-11])
    for tt, jt in ((ttr.LogTransform(1e-10), jtr.LogTransform(1e-10)),
                   (ttr.LimitValueTransform(0.0, 1e-4),
                    jtr.LimitValueTransform(0.0, 1e-4)),
                   (ttr.LimitValueTransform(None, None),
                    jtr.LimitValueTransform(None, None))):
        for a_t, a_j in ((x.copy(), x.copy()),
                         (torch.as_tensor(x), jnp.asarray(x))):
            _close(tt.forward(a_t), jt.forward(a_j))
            _close(tt.backward(a_t), jt.backward(a_j))
    cin = np.abs(rng.randn(300)) * 1e-4
    cout = cin + rng.randn(300) * 1e-5
    cout[::7], cout[::11] = 0.0, cin[::11]
    for (a_t, b_t), (a_j, b_j) in (((cin, cout), (cin, cout)),
                                   ((torch.as_tensor(cin),
                                     torch.as_tensor(cout)),
                                    (jnp.asarray(cin), jnp.asarray(cout)))):
        _dicts_close(ttr.classify(a_t, b_t, 900.0),
                     jtr.classify(a_j, b_j, 900.0))


def test_conditionally_scaled_bins_in_the_inputs_dtype():
    """The tensor path looks the bins up with torch.searchsorted(right=
    True) on the edges in the input's dtype: on float64 tensors the same
    bins as numpy's side="right", values on an edge included."""
    sample = _gscond_sample(n=400)
    t = ttr.ConditionallyScaled(to="s", source=jtr.QV_GSCOND,
                                condition_on=jtr.T_INPUT, bins=5)
    t = t.build(sample)
    cond = sample[jtr.T_INPUT].copy()
    cond[0, :3] = t.params()["edges"][:3]  # exactly on edges
    got = t._bin(torch.as_tensor(cond)).numpy()
    np.testing.assert_array_equal(got, t._bin(cond))
    assert got.dtype == np.int64


SPEC = """
- {kind: log, source: cloud_water_mixing_ratio_input, to: log_cloud_input,
   epsilon: 1.0e-10}
- {to: tdiff, before: air_temperature_input,
   after: air_temperature_after_gscond}
- {to: qvdiff, before: specific_humidity_input,
   after: specific_humidity_after_gscond}
- {to: qv_scaled, source: qvdiff, condition_on: air_temperature_input,
   bins: 6, fit_filter_magnitude: 1.0e-12}
- {kind: classes_v1_one_hot, timestep: 900.0}
- {kind: gscond_route}
- {kind: cloud_limiter}
- {kind: relative_humidity}
- {kind: limit, source: cloud_water_mixing_ratio_after_gscond,
   to: cloud_limited, lower: 0.0}
"""


def test_composed_transform_from_yaml_matches_jax():
    specs = yaml.safe_load(SPEC)
    sample = _gscond_sample(seed=2)
    tt = ttr.compose_from_config(specs).build(dict(sample))
    jt = jtr.compose_from_config(specs).build(dict(sample))
    assert [type(t).__name__ for t in tt.transforms] == [
        type(t).__name__ for t in jt.transforms]
    for req in ({"log_cloud_input", "qv_scaled", "relative_humidity"},
                {"tdiff", "gscond_classes"}):
        assert tt.forward_input_names(set(req)) == jt.forward_input_names(
            set(req))
    assert tt.backward_names({jtr.CLOUD_GSCOND, jtr.T_GSCOND}) == (
        jt.backward_names({jtr.CLOUD_GSCOND, jtr.T_GSCOND}))
    for (tx, jx) in _each_kind(sample):
        fwd_t, fwd_j = tt.forward(dict(tx)), jt.forward(dict(jx))
        _dicts_close(fwd_t, fwd_j)
        y_t, y_j = dict(fwd_t), dict(fwd_j)
        for k in (jtr.T_GSCOND, jtr.QV_GSCOND, jtr.CLOUD_GSCOND):
            del y_t[k], y_j[k]
        _dicts_close(tt.backward(y_t), jt.backward(y_j))


# --- masks and hooks ----------------------------------------------------------


def test_masks_match_jax():
    rng = np.random.RandomState(6)
    state = {"q_input": rng.randn(6, 4, 3, 3), "q": rng.randn(6, 4, 3, 3)}
    em = {"q": 3.0 * rng.randn(6, 4, 3, 3), "other": rng.randn(6, 4, 3, 3)}
    for tm, jm in (
        (temu.RangeMask("q", min=-1.0, max=2.0),
         jemu.RangeMask("q", min=-1.0, max=2.0)),
        (temu.RangeMask("q", min=-1.0), jemu.RangeMask("q", min=-1.0)),
        (temu.LevelMask("q", start=1, stop=3, fill_value_key="q_input"),
         jemu.LevelMask("q", start=1, stop=3, fill_value_key="q_input")),
    ):
        _dicts_close(tm(state, dict(em)), jm(state, dict(em)))
    t0 = datetime.datetime(2020, 1, 1)
    ts = temu.IntervalSchedule(datetime.timedelta(hours=1), t0)
    js = jemu.IntervalSchedule(datetime.timedelta(hours=1), t0)
    for minutes in (0, 30, 61, 90, 150):
        time = t0 + datetime.timedelta(minutes=minutes)
        assert ts(time) == js(time)
        _dicts_close(temu.TimeMask(ts)(time, state, dict(em)),
                     jemu.TimeMask(js)(time, state, dict(em)))


def test_microphysics_hook_range_mask_clip(tmp_path):
    """tests/test_aux_components.py::test_emulation_hook_roundtrip in
    both packages: a constant emulator clipped by a RangeMask, through a
    dump each package wrote and the other loads."""
    for f, emu, path in ((tfit, temu, "port"), (jfit, jemu, "jax")):
        base = f.ConstantOutputPredictor(
            ["air_temperature_input"], ["tendency_of_cloud_water"],
            {"tendency_of_cloud_water": -5.0})
        f.dump(base, str(tmp_path / path))
    outs = []
    for emu, path, kw in ((temu, "jax", {"device": "cpu"}),
                          (jemu, "port", {})):
        hook = emu.MicrophysicsHook(
            str(tmp_path / path),
            masks=[emu.RangeMask("tendency_of_cloud_water", min=-1.0)], **kw)
        state = {"air_temperature_input": np.full((6, 4, 3, 3), 280.0)}
        hook.microphysics(state)
        outs.append(state)
    assert sorted(outs[0]) == sorted(outs[1])
    np.testing.assert_allclose(outs[0]["tendency_of_cloud_water_output"],
                               -1.0)
    np.testing.assert_array_equal(outs[0]["tendency_of_cloud_water_output"],
                                  outs[1]["tendency_of_cloud_water_output"])


def test_get_hooks_and_storage_match_jax(tmp_path, monkeypatch):
    """No configuration: three no-ops.  A storage configuration stores
    the pushed state each output_freq_sec of model time under
    ./state_output.zarr, as the JAX package's hook does."""
    from fv3net_tpu.io.zarr_lite import ZarrLiteStore as JStore
    from fv3net_tpu_torch.io.zarr_lite import ZarrLiteStore as TStore

    for emu in (temu, jemu):
        hooks = emu.get_hooks()
        state = {"a": np.zeros(3)}
        for h in hooks:
            h(state)
        assert set(state) == {"a"}
    rng = np.random.RandomState(7)
    pushed = [{"air_temperature_input": rng.randn(6, 3, 2, 2),
               "total_precipitation": rng.rand(6, 2, 2),
               "time": datetime.datetime(2000, 1, 1)} for _ in range(4)]
    stores = {}
    for emu, Store, name in ((temu, TStore, "port"), (jemu, JStore, "jax")):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        _, _, store = emu.get_hooks(emu.EmulationConfig(
            storage=emu.StorageConfig(output_freq_sec=1800)))
        for sd in pushed:
            store(sd)
        stores[name] = Store(str(tmp_path / name / "state_output.zarr"))
    assert sorted(stores["port"].arrays()) == sorted(stores["jax"].arrays())
    for k in stores["jax"].arrays():
        got = stores["port"].read(k)
        assert got.shape[0] == 2  # the 1st and 3rd of 4 calls at 900 s
        np.testing.assert_array_equal(got, stores["jax"].read(k))


# --- the transformed family ---------------------------------------------------


def _hp(pkg, **kw):
    cfg = dataclasses.replace(_train_config(), **kw)
    if pkg == "torch":
        return ttr_fit.TransformedParameters.from_dict(
            dataclasses.asdict(cfg))
    return cfg


@pytest.mark.parametrize("epochs,batch_size,rtol", [
    (1, 2048, STEP_RTOL), (2, 256, 1e-5)])
def test_train_transformed_matches_jax(monkeypatch, epochs, batch_size,
                                       rtol):
    """tests/test_transformed_training.py's spec (log cloud, T and q
    differences, two heads on a depth-2 trunk) from the same initial
    parameters: one step on one batch of every sample, and two epochs of
    8 batches; parameters, norms and predictions."""
    batch = _synthetic_gscond_batch()
    use_jax_init(monkeypatch, jtr_fit._MultiHead((64, 64), (8, 8)),
                 (1, 24), 0)
    jm = jtr_fit.train_transformed(
        _hp("jax", epochs=epochs, batch_size=batch_size), [batch])
    tm = ttr_fit.train_transformed(
        _hp("torch", epochs=epochs, batch_size=batch_size), [batch],
        device="cpu")
    assert tm.input_variables == jm.input_variables
    assert tm.output_variables == jm.output_variables
    for k, v in jm.norms.items():
        np.testing.assert_array_equal(tm.norms[k], v)
    assert_params_close(jm.params, tm.module, rtol, f"{epochs} epochs")
    test = _synthetic_gscond_batch(seed=5, n=512)
    x = {k: test[k] for k in jm.input_variables}
    want = jm.predict({k: JQuantity(v, ("sample", "z")) for k, v in
                       x.items()})
    got = tm.predict({k: TQuantity(v, ("sample", "z")) for k, v in
                      x.items()})
    for k in want:
        assert got[k].dims == want[k].dims
        assert_close_scaled(got[k].values - test[jtr.T_INPUT]
                            if k == jtr.T_GSCOND else got[k].values,
                            want[k].values - test[jtr.T_INPUT]
                            if k == jtr.T_GSCOND else want[k].values,
                            PRED_RTOL, k)


# --- one emulated physics step ------------------------------------------------

# The gscond emulator of the card's emulated run: tests/test_transformed_
# training.py's spec (log cloud, T and q differences) predicts
# *_after_gscond of T and q; a DerivedModel gives them the state's names
# (fv3net_tpu_torch.emulation.gscond, the glue chip_smoke.py uses too).


@pytest.fixture
def derived_gscond():
    with gscond.named_outputs(jfit.DerivedModel, tfit.DerivedModel):
        yield


def test_gscond_named_outputs_conserve_water_and_restore_the_registry():
    """Inside named_outputs a DerivedModel over a gscond prediction gives
    T and q as predicted and the cloud as the water the humidity change
    leaves (cloud_in + qv_in - qv, never below 0); outside it the
    registry is as it was."""
    before = dict(tfit.DerivedModel.DERIVED_FUNCTIONS)
    rng = np.random.RandomState(3)
    dims = ("sample", "z")
    qv_in = 1e-2 * rng.rand(50, 4)
    cloud_in = 1e-4 * rng.rand(50, 4)
    X = {ttr.QV_INPUT: TQuantity(qv_in, dims),
         ttr.CLOUD_INPUT: TQuantity(cloud_in, dims)}
    qv = qv_in + 2e-4 * (rng.rand(50, 4) - 0.5)
    out = {ttr.T_GSCOND: TQuantity(250.0 + rng.rand(50, 4), dims),
           ttr.QV_GSCOND: TQuantity(qv, dims)}
    with gscond.named_outputs():
        got = {v: tfit.DerivedModel.DERIVED_FUNCTIONS[v](X, out)
               for v in gscond.EMULATED}
    assert tfit.DerivedModel.DERIVED_FUNCTIONS == before
    t, q, cloud = (np.asarray(got[v].data) for v in gscond.EMULATED)
    assert cloud.min() >= 0.0
    np.testing.assert_allclose(q + cloud, qv_in + cloud_in, rtol=1e-14)
    kept = cloud_in + qv_in - qv >= 0.0
    assert 0 < kept.sum() < kept.size
    np.testing.assert_array_equal(q[kept], qv[kept])
    np.testing.assert_array_equal(t[kept], out[ttr.T_GSCOND].data[kept])
    assert np.all(t[~kept] > out[ttr.T_GSCOND].data[~kept])


def test_emulated_apply_physics_matches_jax(tmp_path, derived_gscond):
    """The GFS suite's apply_physics at C6 x 8 in float64 with the same
    dumped gscond emulator (trained by the JAX package) behind
    get_hooks(EmulationConfig(gscond=...)) in both packages: the state
    after the step agrees, the emulator took effect (the state differs
    from the physics' own step) and the water after the step equals the
    physics' own (the emulator conserves water)."""
    from fv3net_tpu_torch.runtime import names
    from test_torch_runtime import PKGS, _init, _moisten

    base = jtr_fit.train_transformed(
        dataclasses.replace(_train_config(), epochs=3),
        [_synthetic_gscond_batch()])
    path = str(tmp_path / "emulator")
    jfit.dump(jfit.DerivedModel(base, list(gscond.EMULATED)), path)
    after = {}
    fields = (names.TEMP, names.SPHUM, names.CLOUD, names.TOTAL_PRECIP)
    for pkg, emu in (("jax", jemu), ("torch", temu)):
        wrapper = PKGS[pkg][0]
        for emulated in (False, True):
            mdl = _init(pkg, physics_suite="gfs", do_radiation=False)
            _moisten(wrapper, mdl, seed=4)
            kw = {"device": "cpu"} if pkg == "torch" else {}
            mdl.emulation_hooks = emu.get_hooks(emu.EmulationConfig(
                gscond=emu.ModelConfig(path=path) if emulated else None),
                **kw)
            wrapper.apply_physics()
            st = wrapper.get_state(list(fields) + [names.DELP])
            after[pkg, emulated] = {k: np.array(st[k].values)
                                    for k in fields}
            after[pkg, emulated]["water"] = float(
                ((st[names.SPHUM].values + st[names.CLOUD].values)
                 * st[names.DELP].values).sum() / 9.80665
                + 1000.0 * st[names.TOTAL_PRECIP].values.sum())
            wrapper.cleanup()
    for k in fields:
        assert_close_scaled(after["torch", False][k], after["jax", False][k],
                            1e-12, k)
        effect = np.abs(after["jax", True][k] - after["jax", False][k]).max()
        err = np.abs(after["torch", True][k] - after["jax", True][k]).max()
        assert err <= EMU_RTOL * effect + 1e-12 * np.abs(
            after["jax", True][k]).max(), (k, err, effect)
    assert not np.allclose(after["torch", True][names.CLOUD],
                           after["torch", False][names.CLOUD], rtol=1e-3)
    w_emu, w_phys = after["torch", True]["water"], after["torch", False][
        "water"]
    assert abs(w_emu / w_phys - 1.0) < 1e-12
