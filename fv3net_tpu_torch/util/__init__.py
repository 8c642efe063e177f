from .quantity import Quantity, State

__all__ = ["Quantity", "State"]
