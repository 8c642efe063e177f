from .zenith import cos_zenith_angle

__all__ = ["cos_zenith_angle"]
