"""The coupling runtime: the eager TimeLoop over the wrapper's phases
(loop, steppers, derived state, diagnostics, metrics, segmented runs and
the ``runfv3`` CLI) and the coupled step of ``compiled_loop``."""

from . import names
from .config import UserConfig, get_config
from .derived_state import DerivedModelState
from .loop import Monitor, Stepper, TimeLoop, add_tendency

__all__ = [
    "TimeLoop",
    "Stepper",
    "Monitor",
    "add_tendency",
    "DerivedModelState",
    "UserConfig",
    "get_config",
    "names",
]
