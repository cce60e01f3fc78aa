"""Batched 3-vector math on ``(..., 3)`` tensors.

PyTorch counterpart of ``xraytracer_tpu/math/vec.py`` and of the
reference's scalar ``Vec3``/optics utilities (reference:
Src/geometry.h:135-268, Src/geometry.cpp:23-89). Everything is
shape-polymorphic over leading batch dimensions and has no data-dependent
branches (``torch.where`` everywhere).
"""

import torch


def dot(a, b):
    """Batched dot product over the trailing axis, keeps no dims. -> (...,)"""
    return torch.sum(a * b, dim=-1)


def dot_keep(a, b):
    """Batched dot product, keepdims. -> (..., 1)"""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length(v):
    return torch.sqrt(dot(v, v))


def length2(v):
    return dot(v, v)


def normalize(v, eps=0.0):
    """v / |v|. With eps=0 this matches the reference exactly (can produce
    inf/nan on zero vectors, as the C++ does)."""
    n = length(v)[..., None]
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def vmin(a, b):
    return torch.minimum(a, b)


def vmax(a, b):
    return torch.maximum(a, b)


def orthonormal_basis(n):
    """Branchless (Pixar) ONB construction around unit normal ``n``.

    Returns (t, b) tangent/bitangent, matching the reference's active branch
    (reference: Src/geometry.cpp:43-48, the ``#else`` Duff et al. variant).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.copysign(torch.ones_like(nz), nz)
    a = -1.0 / (sign + nz)
    c = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * c, -sign * nx], dim=-1)
    b = torch.stack([c, sign + ny * ny * a, -ny], dim=-1)
    return t, b


def reflect(i, n):
    """Mirror reflection of incident direction ``i`` about normal ``n``
    (reference: Src/geometry.cpp:52-55)."""
    return i - 2.0 * dot_keep(i, n) * n


def _lanes(x, like):
    """Scalar or (...,) ``x`` broadcast to ``like``'s shape, dtype, device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(
        like.shape
    )


def refract(i, n, ior):
    """Snell refraction with total-internal-reflection -> zero vector
    (reference: Src/geometry.cpp:57-67). ``ior`` may be scalar or (...,)."""
    cosi = torch.clamp(dot(i, n), -1.0, 1.0)
    ior = _lanes(ior, cosi)
    entering = cosi < 0.0
    etai = torch.where(entering, 1.0, ior)
    etat = torch.where(entering, ior, 1.0)
    nn = torch.where(entering[..., None], n, -n)
    cosi = torch.abs(cosi)
    eta = etai / etat
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta[..., None] * i + (
        eta * cosi - torch.sqrt(torch.clamp(k, min=0.0))
    )[..., None] * nn
    return torch.where((k < 0.0)[..., None], torch.zeros_like(i), refr)


def fresnel(i, n, ior):
    """Unpolarized Fresnel reflectance kr (reference: Src/geometry.cpp:69-89).

    Returns kr in [0, 1]; kr == 1 on total internal reflection.
    """
    cosi = torch.clamp(dot(i, n), -1.0, 1.0)
    ior = _lanes(ior, cosi)
    exiting = cosi > 0.0
    etai = torch.where(exiting, ior, 1.0)
    etat = torch.where(exiting, 1.0, ior)
    sint = etai / etat * torch.sqrt(torch.clamp(1.0 - cosi * cosi, min=0.0))
    cost = torch.sqrt(torch.clamp(1.0 - sint * sint, min=0.0))
    cosa = torch.abs(cosi)
    rs = (etat * cosa - etai * cost) / (etat * cosa + etai * cost)
    rp = (etai * cosa - etat * cost) / (etai * cosa + etat * cost)
    kr = 0.5 * (rs * rs + rp * rp)
    return torch.where(sint >= 1.0, torch.ones_like(kr), kr)


def take_rows(table, rows):
    """``table[rows]`` for an int64 index vector, as ``torch.index_select``.
    Same values; the difference is the gradient: index_select's is a
    scatter-add (atomic adds on the card), while the gradient of
    ``table[rows]`` sorts the indices and sums the duplicates of each row
    serially, which is ruinous when every lane of a wavefront reads one of a
    few rows (a material's albedo, a light's emission): over 90% of an
    autograd step's time at 780x585 on an H100 (PERF.md, PR 5)."""
    return torch.index_select(table, 0, rows)


def world_to_local(v, lx, ly, lz):
    """Direction from world into the (lx, ly, lz) frame
    (reference: Src/geometry.h:686-691)."""
    return torch.stack([dot(v, lx), dot(v, ly), dot(v, lz)], dim=-1)


def local_to_world(v, lx, ly, lz):
    """Direction from the (lx, ly, lz) frame into world
    (reference: Src/geometry.h:694-701)."""
    return v[..., 0:1] * lx + v[..., 1:2] * ly + v[..., 2:3] * lz
