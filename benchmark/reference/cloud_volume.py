"""Plain reference of the reference renderer's own volume example
(Src/examples/volume.cpp): ``cloud_nee``'s estimator with NEE off, as
``VolumePathTracing`` (Src/integrator.h:401-478) renders it: no light pick,
no cone sample, no ratio tracking, and Le added at every emitter hit."""

import torch

from .cloud_nee import NEE, CloudNEE


def make(config, grid, device, dt=torch.float32):
    """The configuration's reference over the density grid the run made."""
    if NEE[config["render"]["integrator"]]:
        raise ValueError("cloud_volume is the estimator without NEE")
    return CloudNEE(config, grid, device, dt)
