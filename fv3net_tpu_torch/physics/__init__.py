from .gfs import GFSPhysicsConfig, gfs_physics_step
from .simple import saturation_adjustment

__all__ = ["GFSPhysicsConfig", "gfs_physics_step", "saturation_adjustment"]
