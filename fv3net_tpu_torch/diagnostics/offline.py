"""Offline ML diagnostics: evaluate a trained Predictor against a mapper
(a copy of the JAX package's ``diagnostics/offline.py``).

The reference evaluates trained models offline — predictions vs the
held-out target data of a loaders mapper, reduced to R^2 / bias / RMSE
per variable, per level, and per surface-type domain, plus Jacobians
for column models — and renders an HTML report
(workflows/diagnostics/fv3net/diagnostics/offline/compute.py:131-165,
compute_diagnostics.py:21-31 DOMAINS, offline/views/create_report.py).
The reductions are host numpy around ``fit.load``: the model predicts on
the CUDA device unless ``evaluate`` is given another, and its
predictions come back as numpy.  Exposed through ``python -m
fv3net_tpu_torch.diagnostics.cli offline``.

Conventions: mapper states hold Quantities of shape [tile, y, x] (2D)
or [tile, z, y, x] (3D); predictions are stacked over the evaluated
timesteps to [time, tile, (z,) y, x] before reduction.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from .report import HTMLReport, write_report

DOMAINS = ("global", "land", "sea")
DELP = "pressure_thickness_of_atmospheric_layer"
LAND_SEA_MASK = "land_sea_mask"


def predict_over_mapper(
    predictor,
    mapper: Mapping,
    times: Optional[Sequence[str]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], dict]:
    """Run the predictor over the mapper's (test) timesteps.

    Returns (prediction, target, extras) — dicts of stacked
    [time, ...] arrays for every output variable; extras carries delp
    and land_sea_mask stacks when the mapper provides them
    (compute.py:296-340 get_prediction role).
    """
    times = sorted(times if times is not None else mapper.keys())
    if not times:
        raise ValueError("mapper has no timesteps to evaluate")
    pred_stacks: Dict[str, list] = {}
    targ_stacks: Dict[str, list] = {}
    extras: Dict[str, list] = {}
    for t in times:
        state = mapper[t]
        inputs = {k: state[k] for k in predictor.input_variables}
        pred = predictor.predict(inputs)
        for v in predictor.output_variables:
            if v not in state:
                raise KeyError(
                    f"mapper state at {t} lacks target variable {v!r}"
                )
            pred_stacks.setdefault(v, []).append(
                np.asarray(pred[v].values, np.float64)
            )
            targ_stacks.setdefault(v, []).append(
                np.asarray(state[v].values, np.float64)
            )
        for aux in (DELP, LAND_SEA_MASK):
            if aux in state:
                extras.setdefault(aux, []).append(
                    np.asarray(state[aux].values, np.float64)
                )
    prediction = {v: np.stack(s) for v, s in pred_stacks.items()}
    target = {v: np.stack(s) for v, s in targ_stacks.items()}
    extra = {k: np.stack(s) for k, s in extras.items()}
    extra["times"] = list(times)
    return prediction, target, extra


def _domain_weights(grid: Mapping, extras: Mapping, shape, domain: str):
    """Area weights restricted to a surface-type domain
    (compute_diagnostics.py:21-28: land/sea/global enumeration)."""
    area = np.asarray(grid["area"], np.float64)  # [tile, y, x]
    w = np.broadcast_to(area, shape).copy()
    if domain == "global":
        return w
    mask = extras.get(LAND_SEA_MASK)
    if mask is None and LAND_SEA_MASK in grid:
        mask = np.asarray(grid[LAND_SEA_MASK])
    if mask is None:
        return None
    mask = np.asarray(mask)
    if mask.ndim == 4:  # [time, tile, y, x] -> static
        mask = mask[0]
    land = np.rint(mask) == 1.0
    sel = land if domain == "land" else ~land
    return w * np.broadcast_to(sel, shape)


def _wmean(a, w, axes=None):
    s = w.sum(axis=axes)
    return (a * w).sum(axis=axes) / np.where(s == 0, 1.0, s)


def _scores(p, t, w, axes=None):
    """bias / rmse / r2 with weights w over `axes`."""
    bias = _wmean(p - t, w, axes)
    mse = _wmean((p - t) ** 2, w, axes)
    tm = _wmean(t, w, axes)
    var = _wmean(
        (t - (tm if axes is None else np.expand_dims(
            tm, axes if isinstance(axes, tuple) else (axes,)
        ))) ** 2,
        w, axes,
    )
    r2 = 1.0 - mse / np.where(var == 0, np.nan, var)
    return bias, np.sqrt(mse), r2


def compute_offline_diagnostics(
    prediction: Mapping[str, np.ndarray],
    target: Mapping[str, np.ndarray],
    grid: Mapping,
    extras: Optional[Mapping] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """R^2 / bias / RMSE per variable + domain, per-level profiles for
    3D variables, column integrals when delp is available
    (compute.py:131-165 _compute_diagnostics; _helpers.compute_r2,
    insert_rmse, insert_column_integrated_vars roles).

    Returns (diags, scalar_metrics): diags holds profile/map arrays;
    scalar_metrics is flat {name: float} (scalar_metrics.json).
    """
    extras = extras or {}
    diags: Dict[str, np.ndarray] = {}
    metrics: Dict[str, float] = {}
    delp = extras.get(DELP)
    for var in sorted(prediction):
        p, t = prediction[var], target[var]
        is3d = p.ndim == 5  # [time, tile, z, y, x]
        for domain in DOMAINS:
            w2 = _domain_weights(
                grid, extras,
                p.shape[:2] + p.shape[-2:], domain,
            )
            if w2 is None:
                continue  # no surface-type information
            w = w2[:, :, None] if is3d else w2
            wb = np.broadcast_to(w, p.shape)
            bias, rmse, r2 = _scores(p, t, wb)
            metrics[f"{var}_bias_{domain}"] = float(bias)
            metrics[f"{var}_rmse_{domain}"] = float(rmse)
            metrics[f"{var}_r2_{domain}"] = float(r2)
        if is3d:
            # per-level profiles over (time, tile, y, x)
            wb = np.broadcast_to(
                _domain_weights(
                    grid, extras, p.shape[:2] + p.shape[-2:], "global"
                )[:, :, None],
                p.shape,
            )
            bias, rmse, r2 = _scores(p, t, wb, axes=(0, 1, 3, 4))
            diags[f"{var}_bias_profile"] = bias
            diags[f"{var}_rmse_profile"] = rmse
            diags[f"{var}_r2_profile"] = r2
            if delp is not None and delp.shape == p.shape:
                from ..constants import GRAV

                ci_p = (p * delp).sum(axis=2) / GRAV
                ci_t = (t * delp).sum(axis=2) / GRAV
                w2 = _domain_weights(
                    grid, extras, ci_p.shape, "global"
                )
                bias, rmse, r2 = _scores(ci_p, ci_t, w2)
                metrics[f"column_integrated_{var}_bias_global"] = float(
                    bias
                )
                metrics[f"column_integrated_{var}_r2_global"] = float(r2)
        # time-mean bias map (snapshot-style view, compute.py transect
        # role reduced to a map in this environment)
        diags[f"{var}_time_mean_bias_map"] = (p - t).mean(
            axis=tuple(range(p.ndim - 2))
        )
    return diags, metrics


def column_jacobian(
    predictor,
    sample_state: Mapping,
    rel_eps: float = 0.001,
) -> Dict[str, np.ndarray]:
    """Normalized Jacobian d(out)/d(in) of a column model around the
    horizontal-mean profile (fv3fit/keras/jacobian.py role via central
    finite differences — backend-agnostic, works for every Predictor
    family).

    Each entry ``{out_var}/{in_var}`` has shape [n_out_z, n_in_z];
    inputs are perturbed by rel_eps * std(input) per level and the
    response is normalized by std(output) so entries are comparable.
    """
    from ..util.quantity import Quantity

    def mean_column(q):
        a = np.asarray(q.values, np.float64)
        if a.ndim == 4:  # [tile, z, y, x]
            prof = a.mean(axis=(0, 2, 3))
        elif a.ndim == 3:
            prof = a.mean(keepdims=False)[None]
        else:
            raise ValueError(f"unsupported rank {a.ndim}")
        return prof

    base_cols = {}
    stds = {}
    for v in predictor.input_variables:
        prof = mean_column(sample_state[v])
        base_cols[v] = prof
        stds[v] = float(np.asarray(sample_state[v].values).std()) or 1.0

    def state_from(cols):
        return {
            v: Quantity(
                cols[v].astype(np.float32).reshape(1, -1, 1, 1),
                ("tile", "z", "y", "x"), "",
            )
            for v in cols
        }

    def col_out(pred):
        return {
            v: np.asarray(pred[v].values, np.float64).reshape(-1)
            for v in predictor.output_variables
        }

    base = col_out(predictor.predict(state_from(base_cols)))
    out_stds = {
        v: float(np.asarray(sample_state[v].values).std()) or 1.0
        for v in predictor.output_variables
        if v in sample_state
    }
    jac: Dict[str, np.ndarray] = {}
    for vin in predictor.input_variables:
        nzin = base_cols[vin].size
        cols_plus = []
        for k in range(nzin):
            eps = rel_eps * stds[vin]
            up = dict(base_cols)
            up[vin] = base_cols[vin].copy()
            up[vin][k] += eps
            dn = dict(base_cols)
            dn[vin] = base_cols[vin].copy()
            dn[vin][k] -= eps
            out_up = col_out(predictor.predict(state_from(up)))
            out_dn = col_out(predictor.predict(state_from(dn)))
            cols_plus.append(
                {
                    v: (out_up[v] - out_dn[v]) / (2.0 * eps)
                    for v in base
                }
            )
        for vout in base:
            scale = stds[vin] / out_stds.get(vout, 1.0)
            jac[f"{vout}/{vin}"] = (
                np.stack([c[vout] for c in cols_plus], axis=1) * scale
            )
    return jac


def _heatmap_html(mat: np.ndarray, name: str) -> str:
    """Tiny dependency-free HTML heatmap (report views role)."""
    m = np.asarray(mat, float)
    vmax = np.nanmax(np.abs(m)) or 1.0
    rows = []
    for r in m:
        cells = []
        for v in r:
            x = 0.0 if not np.isfinite(v) else v / vmax
            red = int(255 * max(x, 0))
            blue = int(255 * max(-x, 0))
            cells.append(
                f'<td style="background:rgb({255 - blue},'
                f"{255 - red - blue if red + blue < 255 else 0},"
                f'{255 - red});width:8px;height:8px" '
                f'title="{v:.3g}"></td>'
            )
        rows.append("<tr>" + "".join(cells) + "</tr>")
    return (
        f"<h3>{name}</h3><table style='border-collapse:collapse'>"
        + "".join(rows)
        + f"</table><small>|max| = {vmax:.3g} "
        "(red +, blue −; out levels ↓, in levels →)</small>"
    )


def offline_report(
    diags: Mapping[str, np.ndarray],
    metrics: Mapping[str, float],
    jacobians: Optional[Mapping[str, np.ndarray]],
    output_dir: str,
    title: str = "offline ML diagnostics",
    metadata: Optional[Mapping] = None,
) -> str:
    """diags.npz + scalar_metrics.json + index.html
    (offline/views/create_report.py role)."""
    os.makedirs(output_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(output_dir, "offline_diagnostics.npz"),
        **{k: np.asarray(v) for k, v in diags.items()},
    )
    with open(
        os.path.join(output_dir, "scalar_metrics.json"), "w"
    ) as f:
        json.dump({k: metrics[k] for k in sorted(metrics)}, f,
                  indent=2)
    rep = HTMLReport(title, metadata or {})
    rep.add_table("Scalar metrics", "R2 / bias / RMSE", dict(metrics))
    for name in sorted(diags):
        arr = np.asarray(diags[name])
        if name.endswith("_profile"):
            rep.add_timeseries("Vertical profiles", name, arr)
    if jacobians:
        for name in sorted(jacobians):
            rep.sections.setdefault("Jacobians", []).append(
                _heatmap_html(jacobians[name], name)
            )
        np.savez_compressed(
            os.path.join(output_dir, "jacobians.npz"),
            **{k.replace("/", "__"): v for k, v in jacobians.items()},
        )
    path = os.path.join(output_dir, "index.html")
    write_report(rep, path)
    return path


def evaluate(
    model_path: str,
    mapper: Mapping,
    grid: Mapping,
    output_dir: str,
    times: Optional[Sequence[str]] = None,
    jacobian: bool = True,
    device=None,
) -> Dict[str, float]:
    """Load → predict → reduce → report, one call (the `offline` CLI
    body; compute.py main role).  The model predicts on `device` (the
    CUDA device unless the caller names one; raises without one)."""
    from .. import fit
    from ..device import default_device

    if device is None:
        device = default_device("diagnostics.offline.evaluate")
    predictor = fit.load(model_path, device)
    prediction, target, extras = predict_over_mapper(
        predictor, mapper, times
    )
    diags, metrics = compute_offline_diagnostics(
        prediction, target, grid, extras
    )
    jac = None
    if jacobian:
        sample = mapper[sorted(mapper.keys())[0]]
        ok = all(
            np.asarray(sample[v].values).ndim == 4
            for v in list(predictor.input_variables)
            + [
                v
                for v in predictor.output_variables
                if v in sample
            ]
        )
        if ok:
            try:
                jac = column_jacobian(predictor, sample)
            except Exception:
                jac = None  # non-column models: no Jacobian view
    offline_report(
        diags, metrics, jac, output_dir,
        metadata={"model": model_path, "n_times": len(extras["times"])},
    )
    return metrics
