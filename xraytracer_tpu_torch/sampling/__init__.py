from .rng import (
    SITES_PER_BOUNCE,
    base_key,
    path_keys,
    uniform1,
    uniform2,
    uniform3,
    scalar_uniform,
)
from .warps import (
    uniform_hemisphere,
    cosine_hemisphere,
    uniform_triangle,
    uniform_sphere,
    uniform_cone,
    hg_sample_cos_theta,
    hg_phase,
    hg_sample_direction,
)
from .distribution import DiscreteDistribution1D, channel_pmf, sample_channel

__all__ = [
    "SITES_PER_BOUNCE",
    "base_key",
    "path_keys",
    "uniform1",
    "uniform2",
    "uniform3",
    "scalar_uniform",
    "uniform_hemisphere",
    "cosine_hemisphere",
    "uniform_triangle",
    "uniform_sphere",
    "uniform_cone",
    "hg_sample_cos_theta",
    "hg_phase",
    "hg_sample_direction",
    "DiscreteDistribution1D",
    "channel_pmf",
    "sample_channel",
]
