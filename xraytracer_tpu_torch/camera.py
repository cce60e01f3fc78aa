"""Pinhole camera: batched primary-ray generation.

PyTorch counterpart of ``xraytracer_tpu/camera.py`` and of
``PinholeCamera::sampleRay`` (reference: Src/camera.h:33-60): NDC direction
``((2u-1)s, (1-2v)s/aspect, -1)`` transformed by the row-vector
camera-to-world matrix; origin is the matrix's translation row; pdf is
always 1.
"""

from typing import NamedTuple

import numpy as np
import torch

from .constants import deg2rad
from .device import resolve_device
from .geometry.types import Rays
from .math import normalize, transform_dir


class PinholeCamera(NamedTuple):
    c2w: torch.Tensor     # (4, 4) row-vector camera-to-world
    scale: torch.Tensor   # tan(FOV/2)
    aspect: torch.Tensor  # width / height

    @staticmethod
    def make(aspect_ratio, c2w, fov_deg=90.0, device=None):
        device = resolve_device(device)
        scale = np.tan(np.float32(0.5 * deg2rad(fov_deg)), dtype=np.float32)
        return PinholeCamera(
            c2w=torch.from_numpy(np.array(c2w, np.float32)).to(device),
            scale=torch.tensor(float(scale), dtype=torch.float32, device=device),
            aspect=torch.tensor(
                float(aspect_ratio), dtype=torch.float32, device=device
            ),
        )

    def sample_rays(self, uv) -> Rays:
        """uv: (N, 2) sensor coords in [0,1]^2 -> wavefront of primary rays."""
        d = torch.stack(
            [
                (2.0 * uv[:, 0] - 1.0) * self.scale,
                (1.0 - 2.0 * uv[:, 1]) * self.scale / self.aspect,
                -torch.ones_like(uv[:, 0]),
            ],
            dim=-1,
        )
        d = normalize(transform_dir(self.c2w, d))
        o = self.c2w[3, :3].expand(d.shape).contiguous()
        return Rays(o=o, d=d)
