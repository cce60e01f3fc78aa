"""Shared pieces of the plain references: the counter-based RNG, the pinhole
camera and the small vector helpers.

Written from the published formulas, not from the program under test:

* the RNG is the PCG output permutation (O'Neill's PCG-XSH-RR hash as used
  for GPU rendering by Jarzynski and Olano, "Hash Functions for GPU
  Rendering", JCGT 2020) folded over (seed, pixel id, sample index, site):
  ``key = pcg(pcg(pcg(seed) + pixel) + sample)``, a site's first word
  ``pcg(key + site * 0x9E3779B9)`` and its next words ``pcg(previous)``;
  a word becomes a uniform as its top 24 bits times 2^-24;
* the camera is the reference renderer's pinhole (Src/camera.h:33-60):
  direction ``((2u - 1) s, (1 - 2v) s / aspect, -1)`` through the row-vector
  camera-to-world matrix, normalised, with ``s = tan(fov / 2)`` and the
  sub-pixel jitter of Src/renderer.cpp:42-47 drawn at ``CAMERA_SITE``.

Every float in here is of the dtype the caller passes (float32 for the
reference, bfloat16 for its control); the RNG's integer words are exact in
int64 either way.
"""

import numpy as np
import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
SITES_PER_BOUNCE = 1 << 16
CAMERA_SITE = 0x7FFF0000
PI = 3.14159265359          # the reference renderer's constant (Src/geometry.h)
SHADOW_BIAS = 0.01          # Src/integrator.h:104,260
RAY_EPS = 1e-3              # Src/geometry.h:23
K_EPS = float(np.finfo(np.float32).eps)   # kEpsilon = FLT_EPSILON
INF = float(np.finfo(np.float32).max)     # kInfinity = FLT_MAX


def pcg(x):
    """One PCG-XSH-RR output permutation of uint32 words held in int64."""
    x = (x * 747796405 + 2891336453) & MASK
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & MASK
    return (word >> 22) ^ word


def path_keys(seeds, pixel_ids, samples):
    """(N,) keys of the paths (seed, pixel, sample); every argument an (N,)
    int64 tensor of values in [0, 2^32)."""
    root = pcg(seeds)
    s = pcg((root + pixel_ids) & MASK)
    return pcg((s + samples) & MASK)


def _first_word(keys, site):
    if torch.is_tensor(site):
        site_mul = (site * GOLDEN) & MASK
    else:
        site_mul = ((int(site) & MASK) * GOLDEN) & MASK
    return pcg((keys + site_mul) & MASK)


def to_unit(word, dt):
    return (word >> 8).to(dt) * (1.0 / (1 << 24))


def u1(keys, site, dt):
    return to_unit(_first_word(keys, site), dt)


def u2(keys, site, dt):
    w1 = _first_word(keys, site)
    w2 = pcg(w1)
    return to_unit(w1, dt), to_unit(w2, dt)


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


def onb(n):
    """Duff et al.'s branchless orthonormal basis around the unit ``n``
    ("Building an Orthonormal Basis, Revisited", JCGT 2017): (t, b)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    c = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * c, -sign * nx], dim=-1)
    b = torch.stack([c, sign + ny * ny * a, -ny], dim=-1)
    return t, b


def camera_rays(camera, width, height, pixel_ids, keys, dt):
    """Primary rays (o, d) of the lanes: the pinhole of ``camera`` (a dict
    with ``c2w`` as 16 row-major numbers and ``fov_deg``) at the jittered
    sub-pixel point of each lane's key."""
    dev = keys.device
    c2w = torch.tensor(camera["c2w"], dtype=torch.float64).reshape(4, 4)
    c2w = c2w.to(torch.float32).to(dt).to(dev)
    fov = float(camera["fov_deg"])
    scale = float(np.tan(np.float32(0.5 * (fov / 180.0 * PI)), dtype=np.float32))
    aspect = float(np.float32(width / height))
    ux, uy = u2(keys, CAMERA_SITE, dt)
    px = (pixel_ids % width).to(dt)
    py = (pixel_ids // width).to(dt)
    su = (px + ux) / float(width)
    sv = (py + uy) / float(height)
    dl = torch.stack([
        (2.0 * su - 1.0) * scale,
        (1.0 - 2.0 * sv) * scale / aspect,
        -torch.ones_like(su),
    ], dim=-1)
    # row vector times matrix, written out (no matmul: no TF32 on the card)
    d = normalize(dl[:, 0:1] * c2w[0, :3] + dl[:, 1:2] * c2w[1, :3]
                  + dl[:, 2:3] * c2w[2, :3])
    o = c2w[3, :3].expand(d.shape).contiguous()
    return o, d


def sum_per_pixel(n_pix, lane_pixel, rad):
    """Per-pixel float64 sums of the lanes' radiance (N, 3)."""
    out = torch.zeros((n_pix, 3), dtype=torch.float64, device=rad.device)
    return out.index_add_(0, lane_pixel, rad.to(torch.float64))


def lane_blocks(n, block):
    for s in range(0, n, block):
        yield s, min(s + block, n)

