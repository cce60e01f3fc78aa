"""Counter-based, per-path RNG.

PyTorch counterpart of ``xraytracer_tpu/sampling/rng.py``, bit for bit.
The reference uses one stateful ``std::mt19937`` per pixel, seeded with the
pixel index (reference: Src/sampler.h:37-50, Src/renderer.cpp:35-36), which
gives per-pixel deterministic renders. Here each random draw is a pure
function of

    (seed, global pixel id, sample index, site counter)

so renders are bitwise deterministic regardless of chunking or device
count, and no ``torch.Generator`` is needed. ``site`` counters enumerate
every consumption point inside an integrator; each wavefront bounce offsets
them by ``SITES_PER_BOUNCE``.

Implementation: the PCG output-permutation hash (O'Neill's PCG-XSH-RR family
as popularized for GPU rendering by Jarzynski & Olano, "Hash Functions for
GPU Rendering", JCGT 2020).

uint32 arithmetic in torch: PyTorch has no full uint32 arithmetic, so a
state is an int64 tensor holding a value in [0, 2**32). The wrapping
multiply and the data-dependent logical shift are done in int64 and masked
back to 32 bits after every step that can carry out (both multipliers are
below 2**30, so no product exceeds 2**62). Keys keep that representation
everywhere, including at the renderer/integrator boundary.
"""

import numpy as np
import torch

# Generous per-bounce site budget: every integrator must consume fewer than
# this many distinct random sites per bounce (incl. tracking loop sites).
SITES_PER_BOUNCE = 1 << 16

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # Weyl increment for site separation
_M1 = 747796405
_A1 = 2891336453
_M2 = 277803737
_INV24 = float(np.float32(1.0 / (1 << 24)))


def _pcg(x):
    """One PCG hash round on uint32 lanes held in int64 (pcg-xsh-rr output
    permutation); also takes one Python int (the host-side root state)."""
    x = (x * _M1 + _A1) & _MASK
    word = (((x >> ((x >> 28) + 4)) ^ x) * _M2) & _MASK
    return (word >> 22) ^ word


def _to_unit_float(x):
    """uint32 -> float32 in [0, 1): top 24 bits scaled by 2^-24."""
    return (x >> 8).to(torch.float32) * _INV24


def _u32(x):
    """Integer tensor of any width -> its low 32 bits as int64 (what
    ``astype(uint32)`` does to a negative int32)."""
    return x.to(torch.int64) & _MASK


def _mul32(a, c):
    """(a * c) mod 2**32 for uint32 lanes ``a`` (int64) and a 32-bit Python
    constant ``c``; split so no intermediate exceeds 2**48."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK


def base_key(seed):
    """Root state for a render (Python int in [0, 2**32))."""
    return _pcg(int(seed) & _MASK)


def path_keys(seed, pixel_ids, sample_idx):
    """Per-path uint32 states (int64 tensor): fold the global pixel id and
    the sample index into the root. ``pixel_ids`` is an (N,) integer tensor;
    ``sample_idx`` a Python int or an integer tensor.

    Counterpart of ``sampler->setSeed(j + width * i)`` + the spp loop
    (reference: Src/renderer.cpp:36,42).
    """
    s = _pcg((base_key(seed) + _u32(pixel_ids)) & _MASK)
    if torch.is_tensor(sample_idx):
        sample = _u32(sample_idx)
    else:
        sample = int(sample_idx) & _MASK
    return _pcg((s + sample) & _MASK)


def _site_state(keys, site):
    if torch.is_tensor(site):
        return (keys + _mul32(_u32(site), _GOLDEN)) & _MASK
    return (keys + (((int(site) & _MASK) * _GOLDEN) & _MASK)) & _MASK


def uniform1(keys, site):
    """One uniform float in [0,1) per path. keys: (N,) -> (N,)."""
    return _to_unit_float(_pcg(_site_state(keys, site)))


def uniform2(keys, site):
    """Two uniforms per path -> (N, 2). Consumes a single site."""
    x1 = _pcg(_site_state(keys, site))
    x2 = _pcg(x1)
    return torch.stack([_to_unit_float(x1), _to_unit_float(x2)], dim=-1)


def uniform3(keys, site):
    """Three uniforms per path -> (N, 3). Consumes a single site."""
    x1 = _pcg(_site_state(keys, site))
    x2 = _pcg(x1)
    x3 = _pcg(x2)
    return torch.stack(
        [_to_unit_float(x1), _to_unit_float(x2), _to_unit_float(x3)], dim=-1
    )


def scalar_uniform(key, site, shape=(), device="cpu"):
    """Uniforms from a single (non-batched) state, used by scalar oracles."""
    base = _site_state(
        torch.as_tensor(int(key) & _MASK, dtype=torch.int64, device=device),
        site,
    )
    n = int(np.prod(shape)) if shape else 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    out = _to_unit_float(_pcg((base + _mul32(idx, 0x85EBCA6B)) & _MASK))
    return out.reshape(shape) if shape else out[0]
