from .surface import make_normal_integrator, make_path_integrator

__all__ = ["make_normal_integrator", "make_path_integrator"]
