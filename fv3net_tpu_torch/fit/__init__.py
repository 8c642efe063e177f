from ._shared import ArrayPacker, Predictor, StandardScaler, load, register
from .dense import DenseModel

__all__ = [
    "ArrayPacker",
    "DenseModel",
    "Predictor",
    "StandardScaler",
    "load",
    "register",
]
