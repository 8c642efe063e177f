"""The coupled time loop (compiled_loop) and its host helpers."""

from . import names

__all__ = ["names"]
