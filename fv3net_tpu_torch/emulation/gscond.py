"""A gscond emulator's predictions under the state's names.

``MicrophysicsHook`` writes each prediction under ``<name>_output``, and
``apply_physics`` reads the state's names (``air_temperature_output``,
...).  A transformed gscond emulator predicts ``*_after_gscond`` of the
temperature and the humidity, which nothing reads.  A ``DerivedModel``
over it with ``EMULATED`` as derived outputs gives them the state's names
while ``named_outputs`` is active: T and q as predicted, and the cloud as
the water the predicted humidity change leaves (cloud_in + qv_in - qv),
limited as the Zhao-Carr emulators limit it (``CloudLimiter``), so the
emulator conserves water by construction.

``gscond_outputs`` works on host arrays, so it serves either package's
``DerivedModel``.
"""

from __future__ import annotations

import contextlib

import numpy as np

from . import transforms as tr

EMULATED = ("air_temperature", "specific_humidity",
            "cloud_water_mixing_ratio")


def gscond_outputs(X, out):
    """The emulated T, q and cloud under the state's names (EMULATED), as
    Quantities like the prediction `out[tr.T_GSCOND]`, from the hook's
    inputs X and the transformed model's predictions `out`."""
    qv_in = np.asarray(X[tr.QV_INPUT].data, np.float64)
    cloud_in = np.asarray(X[tr.CLOUD_INPUT].data, np.float64)
    y = {tr.T_GSCOND: np.asarray(out[tr.T_GSCOND].data, np.float64),
         tr.QV_GSCOND: np.asarray(out[tr.QV_GSCOND].data, np.float64)}
    y[tr.CLOUD_GSCOND] = cloud_in + qv_in - y[tr.QV_GSCOND]
    y = tr.CloudLimiter().backward(y)
    ref = out[tr.T_GSCOND]
    return {v: ref.with_data(y[f"{v}_after_gscond"]) for v in EMULATED}


@contextlib.contextmanager
def named_outputs(*model_classes):
    """`gscond_outputs` registered under EMULATED in the derived-function
    registry of each DerivedModel class of `model_classes` (the port's if
    none is given) while the block runs; the registry as it was
    afterwards.  A ``DerivedModel(emulator, EMULATED)`` predicts only
    inside such a block."""
    if not model_classes:
        from ..fit.models import DerivedModel

        model_classes = (DerivedModel,)
    saved = [dict(cls.DERIVED_FUNCTIONS) for cls in model_classes]
    for cls in model_classes:
        for v in EMULATED:
            cls.DERIVED_FUNCTIONS[v] = (
                lambda X, out, v=v: gscond_outputs(X, out)[v])
    try:
        yield
    finally:
        for cls, before in zip(model_classes, saved):
            cls.DERIVED_FUNCTIONS.clear()
            cls.DERIVED_FUNCTIONS.update(before)
