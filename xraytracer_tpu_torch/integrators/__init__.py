from .surface import (
    make_direct_integrator,
    make_furnace_integrator,
    make_normal_integrator,
    make_path_integrator,
    make_whitted_integrator,
)
from .volume import make_volume_integrator

__all__ = [
    "make_direct_integrator", "make_furnace_integrator",
    "make_normal_integrator", "make_path_integrator",
    "make_volume_integrator", "make_whitted_integrator",
]
