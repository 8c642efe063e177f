"""Segmented-run CRUD API (runtime/segmented_run/ equivalent; the JAX
package's ``runtime/segmented_run.py``).

The reference's coarse-grained failure-recovery model (SURVEY 5):
a run URL holds fv3config.yml + numbered segment artifacts; `append`
resumes from the last segment's RESTART store, runs one segment, and
post-processes.  Here a segment is an in-process TimeLoop drive (no
mpirun subprocess -- one device replaces the MPI ranks) and restarts
are zarr-lite stores of the prognostic state.  The model runs on the
CUDA device unless ``append`` is given another (``device="cpu"``).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Optional

import numpy as np
import yaml

logger = logging.getLogger(__name__)

RESTART_NAMES = [
    "pressure_thickness_of_atmospheric_layer",
    "air_temperature",
    "specific_humidity",
    "cloud_water_mixing_ratio",
    "x_wind",
    "y_wind",
    "surface_temperature",
    "total_precipitation",
]


def write_restart(wrapper_mod, path: str):
    """Save the prognostic state (RESTART/ equivalent, zarr-lite)."""
    from ..io.zarr_lite import ZarrLiteStore

    store = ZarrLiteStore(path)
    state = wrapper_mod.get_state(RESTART_NAMES + ["time"])
    for name in RESTART_NAMES:
        q = state[name]
        arr = q.values
        store.create_array(
            name, shape=arr.shape, chunks=arr.shape, dtype=np.float64,
            dims=q.dims, attrs={"units": q.units},
        )
        store.write_full(name, arr.astype(np.float64))
    with open(os.path.join(path, "time.json"), "w") as f:
        json.dump({"time": state["time"].isoformat()}, f)


def read_restart(wrapper_mod, path: str):
    from ..io.zarr_lite import ZarrLiteStore
    from ..util.quantity import Quantity

    store = ZarrLiteStore(path)
    state = {}
    for name in RESTART_NAMES:
        arr = store.read(name)
        attrs = store.attrs(name)
        dims = tuple(attrs.get("_ARRAY_DIMENSIONS", []))
        state[name] = Quantity(arr, dims, attrs.get("units", ""))
    wrapper_mod.set_state(state)
    with open(os.path.join(path, "time.json")) as f:
        t = datetime.datetime.fromisoformat(json.load(f)["time"])
    wrapper_mod.get_model().time = t


def create(url: str, config: dict):
    """Initialize a run directory with its configuration
    (segmented_run/api.py:14)."""
    os.makedirs(url, exist_ok=True)
    if os.listdir(url):
        raise ValueError(f"run directory {url} is not empty")
    with open(os.path.join(url, "fv3config.yml"), "w") as f:
        yaml.safe_dump(config, f)


def _segments(url: str):
    arts = os.path.join(url, "artifacts")
    if not os.path.isdir(arts):
        return []
    return sorted(os.listdir(arts))


def post_process_segment(seg_dir: str, time_chunk: int = 96):
    """Rechunk + float32-encode every zarr store the segment wrote
    (the reference's post-segment `fv3post.post_process` rechunk/
    encode pass, workflows/post_process_run/fv3post/post_process.py:
    49-54): diagnostics land with per-step time chunks; downstream
    readers want large time chunks and compact dtypes."""
    import shutil

    from ..io.zarr_lite import rechunk_store

    for name in sorted(os.listdir(seg_dir)):
        if not name.endswith(".zarr"):
            continue
        src = os.path.join(seg_dir, name)
        if not os.path.isdir(src):
            continue
        tmp = src + ".rechunk"
        try:
            rechunk_store(
                src, tmp, cast="float32", time_chunk=time_chunk
            )
        except (OSError, ValueError, KeyError) as e:
            logger.warning("post-process skip %s: %r", name, e)
            shutil.rmtree(tmp, ignore_errors=True)
            continue
        shutil.rmtree(src)
        os.replace(tmp, src)


def append(url: str, n_steps: Optional[int] = None, device=None) -> int:
    """Run one more segment, resuming from the previous one
    (segmented_run/append.py:37-60), on `device`: the CUDA device unless
    the caller names another; without one the default raises."""
    from .. import wrapper
    from ..device import default_device
    from ..runtime.config import get_config
    from ..runtime.derived_state import DerivedModelState
    from ..runtime.diagnostics import get_diagnostic_files
    from ..runtime.loop import TimeLoop
    from ..runtime.metrics import compute_metrics, log_metrics

    if device is None:
        device = default_device("append")
    with open(os.path.join(url, "fv3config.yml")) as f:
        config_dict = yaml.safe_load(f)
    user_config = get_config(config_dict)
    namelist = config_dict.get("namelist", {})
    model_cfg = wrapper.ModelConfig(
        npx=namelist.get("npx", 13),
        npz=namelist.get("npz", 63),
        dt_atmos=namelist.get("dt_atmos", 900.0),
        k_split=namelist.get("k_split", 1),
        n_split=namelist.get("n_split", 6),
        dtype=namelist.get("dtype", "float32"),
    )
    wrapper.initialize(model_cfg, device=device)

    segments = _segments(url)
    if segments:
        last = os.path.join(url, "artifacts", segments[-1], "RESTART")
        read_restart(wrapper, last)
        logger.info("resumed from %s", last)

    seg_label = f"{len(segments):04d}"
    seg_dir = os.path.join(url, "artifacts", seg_label)
    os.makedirs(seg_dir, exist_ok=True)

    steps = n_steps or namelist.get("segment_steps", 4)
    state = DerivedModelState(wrapper)
    diag_files = get_diagnostic_files(user_config.diagnostics, seg_dir)
    loop = TimeLoop(wrapper, state, model_cfg.dt_atmos, n_steps=steps)
    area = wrapper.get_model().area
    from ..runtime.timing import ScalarSink, write_timing_json

    scalars = ScalarSink(seg_dir)
    for step, (time, diags) in enumerate(loop):
        for df in diag_files:
            df.observe(time, diags)
        metrics = compute_metrics(state, area)
        log_metrics(metrics, time)
        scalars.write(step, time, metrics)
    scalars.close()
    # per-substep min/max/mean wall-clock (loop.py:516-543 analogue)
    loop.log_timings()
    write_timing_json(loop.timer, seg_dir)

    write_restart(wrapper, os.path.join(seg_dir, "RESTART"))
    post_process_segment(seg_dir)
    # lineage breadcrumb (segmented_run/append.py:47-51 StepMetadata)
    from ..utils.artifacts import StepMetadata

    StepMetadata(
        job_type="prognostic_run",
        url=seg_dir,
        dependencies=(
            {"restart": os.path.join(url, "artifacts", segments[-1])}
            if segments
            else None
        ),
    ).print_json()
    return 0
