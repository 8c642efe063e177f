"""Holding a float32 step against a float64 one, and the float32 spread.

One f32 step differs from the same step in float64 by its roundings.  A
step on another device (the card's kernels, its ``powf``, its FMA
contractions) rounds differently, so it cannot be held to the CPU's f32
step itself; it is held to be as close to the float64 step as the CPU's
f32 step is, within a factor (``F32_FACTOR``), field by field
(``f32_rule``).

Where an input puts a limiter or a threshold on a tie (white-noise
winds, humidity clipped flat at a cap), a 1-ulp change of the inputs
moves the CPU's own f32 step further than that.  Such a case is held by
the f32 spread instead: the CPU's f32 steps from the inputs and from
1-ulp perturbations of them (``perturb_ulp``), the worst of them against
float64.  Where the inputs hold two snapshots of a field whose difference
is what counts, both move in the same direction
(``perturb_ulp_grouped``).

``moist_inputs`` and ``wrapper_step`` build the seeded C<n> state and
run one eager wrapper step (``step_dynamics`` ... ``apply_physics``) on
any device, for ``chip_smoke.py`` (card against CPU) and the CPU tests.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

# max|got - f64| <= F32_FACTOR * max|f32 - f64| + FLOOR * max|f64|, with
# the f32 runs the CPU's (one, or the inputs' and their perturbations')
F32_FACTOR = 3.0
FLOOR = 1e-7
SPREAD_RUNS = 5  # 1-ulp perturbations that estimate the f32 spread
PTOP = 300.0  # the wrapper's ModelConfig default


def as_fields(state) -> Mapping[str, torch.Tensor]:
    """A NamedTuple state or a mapping as name -> tensor, without the
    fields that are None."""
    if hasattr(state, "_asdict"):
        state = state._asdict()
    return {k: v for k, v in state.items() if v is not None}


def f32_rule(got, f32_runs: Sequence, ref64, fields=None):
    """Per field: (max|got - f64|, bound, max|f64|, [max|f32 - f64| of
    each f32 run], whether got is finite), in float64 on the CPU.  `got`, each of `f32_runs` and
    `ref64` are NamedTuple states or mappings of name -> tensor; `fields`
    defaults to the fields of `ref64` that are not None."""
    ref = as_fields(ref64)
    got = as_fields(got)
    runs = [as_fields(r) for r in f32_runs]
    out = {}
    for k in fields or ref:
        r = ref[k].double().cpu()
        scale = float(r.abs().max())
        errs = [float((x[k].double().cpu() - r).abs().max()) for x in runs]
        a = got[k].double().cpu()
        bound = F32_FACTOR * max(errs) + FLOOR * scale
        out[k] = (float((a - r).abs().max()), bound, scale, errs,
                  bool(torch.isfinite(a).all()))
    return out


def smooth_wind(shape, phase):
    """A smooth D-grid wind of 5 m/s amplitude varying by level and
    face."""
    f, nz, ny, nx = shape
    y = np.linspace(0.0, 2.0 * np.pi, ny)[:, None]
    x = np.linspace(0.0, 2.0 * np.pi, nx)[None, :]
    lev = 0.1 * np.arange(nz)[:, None, None]
    return np.stack([5.0 * np.sin(y + lev + face + phase) * np.cos(x)
                     for face in range(f)])


def moist_inputs(n, nz, noisy=False, seed=10):
    """Seeded temperature noise (1 K) and humidity at a seeded relative
    humidity per column, up to 10% supersaturated, on the wrapper's
    initial state at C<n> x nz, rounded to f32.

    ``noisy=False``: smooth winds of 5 m/s, and the relative humidity
    falls off aloft as (p / ps)^3, so the humidity needs no cap.
    ``noisy=True``: white-noise winds (5 m/s) and the relative humidity
    at every level, the humidity clipped flat at 20 g/kg (near the top
    the saturation value is not small): ties of the transport's limiter
    and of the saturation adjustment."""
    from . import wrapper
    from .physics import gfs

    wrapper.initialize(
        wrapper.ModelConfig(npx=n + 1, npz=nz, dtype="float64"),
        device="cpu",
    )
    st = wrapper.get_state(["air_temperature", "x_wind", "y_wind"])
    rng = np.random.RandomState(seed)
    t = st["air_temperature"].values + rng.randn(6, nz, n, n)
    _, p = gfs.pressure_fields(wrapper.get_model().state.delp, PTOP)
    rh = rng.uniform(0.5, 1.1, size=(6, 1, n, n))
    p = p.numpy()
    qs = gfs.qsat(torch.as_tensor(t), torch.as_tensor(p)).numpy()
    if noisy:
        q = np.minimum(rh * qs, 0.02)
        u, v = (5.0 * rng.randn(*st[k].shape)
                for k in ("x_wind", "y_wind"))
    else:
        q = rh * (p / p[:, -1:]) ** 3 * qs
        u = smooth_wind(st["x_wind"].shape, 0.0)
        v = smooth_wind(st["y_wind"].shape, 1.0)
    new = {"air_temperature": t, "specific_humidity": q,
           "x_wind": u, "y_wind": v}
    return {k: st.get(k, st["air_temperature"]).with_data(
        x.astype(np.float32)) for k, x in new.items()}


def perturb_ulp(inputs, seed):
    """`inputs` (name -> Quantity, as moist_inputs gives, or name -> host
    array) with every value moved by one f32 ulp, up or down at random
    (seeded)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, q in sorted(inputs.items()):
        x = np.asarray(getattr(q, "values", q), dtype=np.float32)
        up = rng.rand(*x.shape) < 0.5
        to = np.where(up, np.float32(np.inf), np.float32(-np.inf))
        y = np.nextafter(x, to).astype(np.float32)
        out[k] = q.with_data(y) if hasattr(q, "with_data") else y
    return out


def perturb_ulp_grouped(inputs, seed, group):
    """`inputs` (name -> host array, all of one shape) with every value
    moved by one f32 ulp as ``perturb_ulp`` moves it, the fields of one
    group (``group(name)``, e.g. two snapshots of one variable) in the
    same direction at each point: where two of them are equal they stay
    equal, so their difference moves by roundoff, not by an ulp."""
    groups = sorted({group(k) for k in inputs})
    return {k: perturb_ulp({k: v}, seed * len(groups)
                           + groups.index(group(k)))[k]
            for k, v in inputs.items()}


def wrapper_step(n, nz, device, dtype, config, inputs):
    """One eager step through the wrapper's phases (step_dynamics ...
    apply_physics) at C<n> x nz from `inputs`: the state and total
    precipitation, on the CPU in float64."""
    from . import wrapper

    wrapper.initialize(
        wrapper.ModelConfig(npx=n + 1, npz=nz, dtype=dtype, **config),
        device=device,
    )
    wrapper.set_state(inputs)
    for phase in (wrapper.step_dynamics, wrapper.step_pre_radiation,
                  wrapper.step_radiation, wrapper.step_post_radiation_physics,
                  wrapper.apply_physics):
        phase()
    mdl = wrapper.get_model()
    out = {k: x.double().cpu() for k, x in mdl.state._asdict().items()
           if x is not None}
    out["total_precip"] = mdl.total_precip.double().cpu()
    return out
