"""`prognostic_run_diags` CLI of the port (the JAX package's
``diagnostics/cli.py``): compute / metrics / report / movies / offline /
log-viewer / single-run / shell.

Mirrors the reference's subcommand surface
(workflows/diagnostics/fv3net/diagnostics/prognostic_run/cli.py:16-33)
over this framework's registries: ``compute`` runs the ~24 diagnostic
groups over a run's zarr output and saves them (npz + metrics.json),
``metrics`` re-emits the scalar metrics from a saved diagnostics file,
``report`` renders the HTML report, ``movies`` renders PNG frame
sequences of every 2D variable with viz.plot_cube (views/movies.py role;
assembled to .mp4 iff ffmpeg exists), ``offline`` evaluates a trained
model against a mapper (offline/compute.py main), ``log-viewer`` renders
a segmented run's scalar logs, ``single-run`` scores an emulator from a
run's StorageHook capture and ``shell`` opens an interactive shell with
the run loaded.

Usage:
    python -m fv3net_tpu_torch.diagnostics.cli compute RUN_ZARR -o OUTDIR \
        [--verification ZARR] [--device DEVICE]
    python -m fv3net_tpu_torch.diagnostics.cli metrics OUTDIR/diags.npz
    python -m fv3net_tpu_torch.diagnostics.cli report RUN_ZARR -o OUTDIR \
        [--device DEVICE]
    python -m fv3net_tpu_torch.diagnostics.cli movies RUN_ZARR -o OUTDIR
    python -m fv3net_tpu_torch.diagnostics.cli offline MODEL DATA_YAML \
        -o OUTDIR [--no-jacobian] [--device DEVICE]
    python -m fv3net_tpu_torch.diagnostics.cli log-viewer RUNDIR -o OUTDIR
    python -m fv3net_tpu_torch.diagnostics.cli single-run RUNDIR -o OUTDIR
    python -m fv3net_tpu_torch.diagnostics.cli shell RUN_ZARR

``compute`` and ``report`` interpolate to pressure levels, and
``offline`` predicts, on the CUDA device unless --device names another
(``--device cpu``); the other subcommands are host code.  ``movies``
needs matplotlib (imported when it runs).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
from typing import Dict, Optional

import numpy as np


def _load_run(url: str) -> Dict[str, np.ndarray]:
    from .compute import load_run

    run = load_run(url)
    run.pop("time", None)
    return run


def _infer_grid(run: Dict[str, np.ndarray], dt_hours: float):
    """Build area/lat/lon from the run's resolution (the role of the
    reference's vcm.catalog grid entries, which this environment
    resolves by direct construction)."""
    from ..grid import CubedSphereGrid

    n = None
    for arr in run.values():
        if np.ndim(arr) >= 4:
            n = arr.shape[-1]
            break
    if n is None:
        raise ValueError("run contains no [time, tile, y, x] arrays")
    g = CubedSphereGrid.make(n, halo=3)
    sl = g.interior
    return {
        "area": np.asarray(g.area[sl]),
        "lat": np.asarray(g.lat[sl]),
        "lon": np.asarray(g.lon[sl]),
        "dt_hours": dt_hours,
    }


def compute_cmd(url: str, output: str, dt_hours: float = 3.0,
                verification: Optional[str] = None, device=None) -> str:
    from .compute import compute_diagnostics

    run = _load_run(url)
    grid = _infer_grid(run, dt_hours)
    verif = _load_run(verification) if verification else None
    diags, metrics = compute_diagnostics(
        run, grid=grid, verification=verif, device=device
    )
    os.makedirs(output, exist_ok=True)
    diags_path = os.path.join(output, "diags.npz")
    np.savez_compressed(
        diags_path,
        **{k: np.asarray(v) for k, v in diags.items()},
    )
    metrics_path = os.path.join(output, "metrics.json")
    with open(metrics_path, "w") as f:
        json.dump(
            {k: float(v) for k, v in metrics.items()}, f, indent=2,
            sort_keys=True,
        )
    return diags_path


def metrics_cmd(diags_path: str) -> Dict[str, float]:
    """Re-emit scalar metrics from a saved diagnostics archive."""
    metrics_path = os.path.join(
        os.path.dirname(diags_path), "metrics.json"
    )
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            metrics = json.load(f)
    else:
        raise FileNotFoundError(
            f"no metrics.json next to {diags_path}; run `compute` first"
        )
    print(json.dumps(metrics, indent=2, sort_keys=True))
    return metrics


def report_cmd(url: str, output: str, dt_hours: float = 3.0,
               device=None) -> str:
    from .compute import compute_diagnostics
    from .report import HTMLReport, write_report

    run = _load_run(url)
    grid = _infer_grid(run, dt_hours)
    diags, metrics = compute_diagnostics(run, grid=grid, device=device)
    rep = HTMLReport("prognostic run report", {"run": url})
    for name, val in diags.items():
        arr = np.asarray(val)
        if arr.ndim == 1 and arr.size > 1:
            rep.add_timeseries("Timeseries", name, arr)
    rep.add_table("Metrics", "scalar metrics", metrics)
    os.makedirs(output, exist_ok=True)
    path = os.path.join(output, "index.html")
    write_report(rep, path)
    return path


def movies_cmd(url: str, output: str, variables=None,
               max_frames: int = 120) -> Dict[str, str]:
    """PNG frame sequences (+ mp4 when ffmpeg exists) of every 2D run
    variable (views/movies.py role)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..viz import plot_cube

    run = _load_run(url)
    out = {}
    for name, arr in run.items():
        arr = np.asarray(arr)
        if arr.ndim != 4:
            continue
        if variables and name not in variables:
            continue
        var_dir = os.path.join(output, "movies", name)
        os.makedirs(var_dir, exist_ok=True)
        vmin, vmax = np.nanpercentile(arr, [2, 98])
        nt = min(arr.shape[0], max_frames)
        for t in range(nt):
            fig, ax, _ = plot_cube(
                arr[t], vmin=vmin, vmax=vmax,
                title=f"{name} frame {t}",
            )
            fig.savefig(
                os.path.join(var_dir, f"frame_{t:04d}.png"), dpi=72
            )
            plt.close(fig)
        out[name] = var_dir
        if shutil.which("ffmpeg"):
            subprocess.run(
                [
                    "ffmpeg", "-y", "-loglevel", "quiet", "-r", "6",
                    "-i", os.path.join(var_dir, "frame_%04d.png"),
                    os.path.join(output, "movies", f"{name}.mp4"),
                ],
                check=False,
            )
    return out


def offline_cmd(model_path: str, data_yaml: str, output: str,
                no_jacobian: bool = False, device=None) -> Dict[str, float]:
    """Evaluate a dumped Predictor against a mapper's test split
    (workflows/diagnostics/fv3net/diagnostics/offline/compute.py main).

    data_yaml schema::

        mapper_function: open_nudge_to_fine      # data registry name
        mapper_kwargs: {url: /path/to/run}
        timesteps: [ ... ]                       # optional test split
        grid: {resolution: 48}                   # optional; default
                                                 # inferred from data
    """
    import yaml

    from ..data import mapper_functions
    from ..grid import CubedSphereGrid
    from .offline import evaluate

    with open(data_yaml) as f:
        spec = yaml.safe_load(f)
    fn = mapper_functions[spec["mapper_function"]]
    mapper = fn(**spec.get("mapper_kwargs", {}))
    times = spec.get("timesteps")
    n = spec.get("grid", {}).get("resolution")
    if n is None:
        sample = mapper[sorted(mapper.keys())[0]]
        n = next(
            np.asarray(q.values).shape[-1] for q in sample.values()
        )
    g = CubedSphereGrid.make(int(n), halo=3)
    sl = g.interior
    grid = {
        "area": np.asarray(g.area[sl]),
        "lat": np.asarray(g.lat[sl]),
        "lon": np.asarray(g.lon[sl]),
    }
    metrics = evaluate(
        model_path, mapper, grid, output, times=times,
        jacobian=not no_jacobian, device=device,
    )
    print(json.dumps(metrics, indent=2, sort_keys=True))
    return metrics


def log_viewer_cmd(url: str, output: str) -> str:
    """Render a segmented run's per-step scalar logs + substep timings
    into a static HTML page (the role of the reference's streamlit
    `log-viewer` app, diagnostics/prognostic_run/apps/log_viewer.py,
    dependency-free: inline-SVG time series)."""
    from ..runtime.timing import read_scalars
    from .report import HTMLReport, write_report

    # this framework's segmented runs write under url/artifacts/<seg>
    # (runtime/segmented_run.py); accept a bare 'segments/' layout too
    seg_root = None
    for candidate in ("artifacts", "segments"):
        root = os.path.join(url, candidate)
        if os.path.isdir(root):
            seg_root = root
            break
    segs = sorted(os.listdir(seg_root)) if seg_root else [""]
    rep = HTMLReport("run log viewer", {"run": url})
    series: Dict[str, list] = {}
    timing_rows: Dict[str, str] = {}
    for seg in segs:
        seg_dir = os.path.join(seg_root, seg) if seg else url
        sc = os.path.join(seg_dir, "scalars.jsonl")
        if os.path.exists(sc):
            for name, recs in read_scalars(sc).items():
                series.setdefault(name, []).extend(
                    r["value"] for r in recs
                )
        tj = os.path.join(seg_dir, "timing.json")
        if os.path.exists(tj):
            with open(tj) as f:
                t = json.load(f)
            for sub, stats in sorted(t.items()):
                mmm = "/".join(
                    f"{float(stats[k]):.4g}"
                    for k in ("min", "max", "mean")
                    if k in stats
                )
                timing_rows[f"{seg or '.'} {sub} (min/max/mean s)"] = (
                    mmm
                )
    for name, vals in sorted(series.items()):
        rep.add_timeseries("statistics", name, np.asarray(vals))
    if timing_rows:
        rep.add_table("substep timings", "per-segment", timing_rows)
    os.makedirs(output, exist_ok=True)
    path = os.path.join(output, "log_viewer.html")
    write_report(rep, path)
    return path


def single_run_cmd(rundir: str, output: str) -> Dict[str, float]:
    """Per-run emulation skill metrics from a StorageHook capture (the
    role of diagnostics/prognostic_run/emulation/single_run.py): for
    every captured microphysics field, global mean/RMS of the scheme's
    change and -- when an emulator substituted outputs -- the skill of
    the emulator against the physics it replaced."""
    from ..io.zarr_lite import open_zarr_lite
    from .report import HTMLReport, write_report

    store_path = os.path.join(rundir, "state_output.zarr")
    if not os.path.isdir(store_path):
        store_path = rundir
    z = open_zarr_lite(store_path)
    names = set(z.arrays())
    metrics: Dict[str, float] = {}
    rep = HTMLReport("emulation single-run", {"run": rundir})
    for field in ("air_temperature", "specific_humidity",
                  "cloud_water_mixing_ratio"):
        inp = f"{field}_input"
        after = f"{field}_after_precpd"
        if inp in names and after in names:
            a = z.read(inp).astype(np.float64)
            b = z.read(after).astype(np.float64)
            d = b - a
            metrics[f"{field}/tendency_rms"] = float(
                np.sqrt(np.mean(d * d))
            )
            metrics[f"{field}/tendency_mean"] = float(np.mean(d))
            rep.add_timeseries(
                "mp change (per sample)", field,
                d.reshape(d.shape[0], -1).mean(axis=1)
                if d.ndim > 1
                else d,
            )
        out = f"{field}_output"
        if out in names and after in names:
            t = z.read(after).astype(np.float64)
            p = z.read(out).astype(np.float64)
            sse = float(np.sum((p - t) ** 2))
            var = float(np.sum((t - t.mean()) ** 2))
            metrics[f"{field}/emulator_r2"] = (
                1.0 - sse / var if var > 0 else 0.0
            )
    os.makedirs(output, exist_ok=True)
    rep.add_table("metrics", "scalar", dict(sorted(metrics.items())))
    write_report(rep, os.path.join(output, "single_run.html"))
    with open(os.path.join(output, "single_run.json"), "w") as f:
        json.dump(metrics, f, indent=2, sort_keys=True)
    return metrics


def shell_cmd(url: str) -> int:
    """Interactive shell with the run loaded (the reference's `shell`
    subcommand role, prognostic_run/shell.py)."""
    import code

    run = _load_run(url)
    banner = (
        f"loaded run {url!r} as `run` "
        f"({len(run)} variables: {sorted(run)[:8]}...)"
    )
    code.interact(banner=banner, local={"run": run, "np": np})
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="prognostic_run_diags")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("compute", help="run the diagnostics registry")
    p.add_argument("url", help="run diagnostics zarr store")
    p.add_argument("-o", "--output", default="diags_output")
    p.add_argument("--dt-hours", type=float, default=3.0)
    p.add_argument("--verification", default=None)
    p.add_argument(
        "--device", default=None,
        help="torch device of the pressure-level interpolation "
        "(default: the CUDA device)",
    )

    p = sub.add_parser("metrics", help="print scalar metrics")
    p.add_argument("diags", help="path to diags.npz from `compute`")

    p = sub.add_parser("report", help="compute + HTML report")
    p.add_argument("url")
    p.add_argument("-o", "--output", default="diags_output")
    p.add_argument("--dt-hours", type=float, default=3.0)
    p.add_argument(
        "--device", default=None,
        help="torch device of the pressure-level interpolation "
        "(default: the CUDA device)",
    )

    p = sub.add_parser("movies", help="PNG/mp4 renders of 2D fields")
    p.add_argument("url")
    p.add_argument("-o", "--output", default="diags_output")
    p.add_argument("--variables", nargs="*", default=None)
    p.add_argument("--max-frames", type=int, default=120)

    p = sub.add_parser(
        "offline", help="evaluate a trained model against a mapper"
    )
    p.add_argument("model_path", help="dumped Predictor directory")
    p.add_argument("data_yaml", help="mapper spec YAML")
    p.add_argument("-o", "--output", default="offline_diags")
    p.add_argument("--no-jacobian", action="store_true")
    p.add_argument(
        "--device", default=None,
        help="torch device of the model (default: the CUDA device)",
    )

    p = sub.add_parser(
        "log-viewer",
        help="HTML time-series view of a segmented run's scalar logs",
    )
    p.add_argument("url", help="segmented run directory")
    p.add_argument("-o", "--output", default="diags_output")

    p = sub.add_parser(
        "single-run",
        help="emulation skill metrics from one run's StorageHook "
        "capture",
    )
    p.add_argument("url", help="run dir holding state_output.zarr")
    p.add_argument("-o", "--output", default="diags_output")

    p = sub.add_parser(
        "shell", help="interactive shell with the run loaded"
    )
    p.add_argument("url")

    args = parser.parse_args(argv)
    if args.command == "compute":
        path = compute_cmd(args.url, args.output, args.dt_hours,
                           args.verification, args.device)
        print(path)
    elif args.command == "metrics":
        metrics_cmd(args.diags)
    elif args.command == "report":
        print(report_cmd(args.url, args.output, args.dt_hours,
                         args.device))
    elif args.command == "movies":
        out = movies_cmd(args.url, args.output, args.variables,
                         args.max_frames)
        print(json.dumps({k: v for k, v in out.items()}, indent=2))
    elif args.command == "offline":
        offline_cmd(args.model_path, args.data_yaml, args.output,
                    args.no_jacobian, args.device)
    elif args.command == "log-viewer":
        print(log_viewer_cmd(args.url, args.output))
    elif args.command == "single-run":
        print(
            json.dumps(
                single_run_cmd(args.url, args.output), indent=2,
                sort_keys=True,
            )
        )
    elif args.command == "shell":
        return shell_cmd(args.url)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
