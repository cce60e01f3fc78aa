from .surface import make_normal_integrator, make_path_integrator
from .volume import make_volume_integrator

__all__ = [
    "make_normal_integrator", "make_path_integrator", "make_volume_integrator",
]
