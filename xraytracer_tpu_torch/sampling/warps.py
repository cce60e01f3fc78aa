"""Sampling warps: uniform-to-distribution transforms.

PyTorch counterpart of ``xraytracer_tpu/sampling/warps.py``. Each warp
mirrors a sampling routine in the reference (file:line cited per function)
so the two implementations are statistically identical given the same
uniforms. All warps are batched over leading dims and branch-free.
"""

import torch

from ..constants import PI
from ..math import orthonormal_basis, local_to_world


def uniform_hemisphere(u1, u2):
    """Uniform hemisphere around local +Y, ``cos(theta) = u1``
    (reference: Src/material.h:64-73 ``uniformSampleHemisphere``).
    Returns (..., 3) local directions (x, y=cos, z)."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - u1 * u1, min=0.0))
    phi = 2.0 * PI * u2
    return torch.stack(
        [sin_theta * torch.cos(phi), u1, sin_theta * torch.sin(phi)], dim=-1
    )


def cosine_hemisphere(u1, u2):
    """Cosine-weighted hemisphere around local +Y (Malley warp). Not in the
    reference (its Lambert sampling is uniform, Src/material.h:55-61); provided
    as the lower-variance option.
    pdf = cos(theta) / pi."""
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    x = r * torch.cos(phi)
    z = r * torch.sin(phi)
    y = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def uniform_triangle(u, v, a, b, c):
    """sqrt-warp uniform point on triangle ABC
    (reference: Src/light.cpp:43-47 ``uniformSampleTriangle``)."""
    su = torch.sqrt(u)[..., None]
    v = v[..., None]
    return c + (1.0 - su) * (a - c) + (v * su) * (b - c)


def uniform_sphere(u1, u2):
    """Uniform direction on the unit sphere, ``z = 1 - 2 u1``
    (reference: Src/light.cpp:99-105 ``UniformSampleSphere``)."""
    z = 1.0 - 2.0 * u1
    sin_theta = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u2
    return torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, z], dim=-1
    )


def uniform_cone(u1, u2, cos_theta_max, x, y, z):
    """Uniform direction in a cone around ``z``
    (reference: Src/light.cpp:107-113 ``UniformSampleCone``)."""
    cos_theta = (1.0 - u1) + u1 * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * u2
    return (
        (torch.cos(phi) * sin_theta)[..., None] * x
        + (torch.sin(phi) * sin_theta)[..., None] * y
        + cos_theta[..., None] * z
    )


def hg_sample_cos_theta(u, g):
    """Henyey-Greenstein inverse-CDF cos(theta) with isotropic fallback for
    |g| < 1e-3 (reference: Src/medium.h:42-53)."""
    g = torch.as_tensor(g, dtype=u.dtype, device=u.device)
    iso = 2.0 * u - 1.0
    # avoid 0-division in the dead branch
    g_safe = torch.where(torch.abs(g) < 1e-3, torch.ones_like(g), g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u)
    aniso = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    return torch.where(torch.abs(g) < 1e-3, iso, aniso)


def hg_phase(cos_theta, g):
    """HG phase function value (reference: Src/medium.h:29-34)."""
    g = torch.as_tensor(g, dtype=cos_theta.dtype, device=cos_theta.device)
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return (1.0 / (4.0 * PI)) * (1.0 - g * g) / (denom * torch.sqrt(denom))


def hg_sample_direction(wo, u1, u2, g):
    """Sample a scattered direction around ``wo`` from the HG phase function,
    returning (wi, phase_value). Mirrors the reference's frame construction:
    local +Y is ``wo`` and the ONB supplies X/Z (Src/medium.h:54-66)."""
    cos_theta = hg_sample_cos_theta(u1, g)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * u2
    wi_local = torch.stack(
        [torch.cos(phi) * sin_theta, cos_theta, torch.sin(phi) * sin_theta],
        dim=-1,
    )
    t, b = orthonormal_basis(wo)
    wi = local_to_world(wi_local, t, wo, b)
    return wi, hg_phase(cos_theta, g)
