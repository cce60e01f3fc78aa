"""The inputs a run makes: the configuration's scene data and density grid,
the frames' seeds and the pixels the check samples. Everything here is a
function of the configuration and ``--seed``; the program and the plain
reference receive the same arrays."""

import numpy as np

# frame f of a run with seed s renders with the seed s * FRAME_STRIDE + f
FRAME_STRIDE = 1_000_003


def procedural_cloud(res=(64, 64, 64), seed=0):
    """The repository's seeded value-noise puff (the stand-in for the
    reference's wdas_cloud asset), copied so that the benchmark's input does
    not move with the program: three octaves of smoothed random lattices,
    normalised to 1, under an ellipsoid falloff, values below 0.1 set to 0."""
    rng = np.random.default_rng(seed)
    density = np.zeros(res, np.float32)
    for octave, amp in ((4, 1.0), (8, 0.5), (16, 0.25)):
        lattice = rng.random((octave, octave, octave)).astype(np.float32)
        zoom = [r // octave + 1 for r in res]
        up = np.kron(lattice, np.ones(zoom, np.float32))[
            : res[0], : res[1], : res[2]
        ]
        for ax in range(3):
            up = (up + np.roll(up, 1, ax) + np.roll(up, -1, ax)) / 3.0
        density += amp * up
    density /= density.max()
    g = np.stack(
        np.meshgrid(*[np.linspace(-1, 1, r) for r in res], indexing="ij")
    )
    r2 = (g**2).sum(0)
    density = density * np.clip(1.0 - r2, 0.0, 1.0)
    density[density < 0.1] = 0.0
    return density.astype(np.float32)


def density_grid(config):
    """The configuration's density grid (float32) or None."""
    spec = config["scene"].get("density_grid")
    if spec is None:
        return None
    if spec["generator"] != "procedural_cloud":
        raise ValueError(f"unknown density-grid generator {spec['generator']!r}")
    return procedural_cloud(tuple(spec["res"]), int(spec["seed"]))


def frame_seed(seed, frame):
    return int(seed) * FRAME_STRIDE + int(frame)


def checked_pixels(seed, frame, n_pix, k):
    """The ``k`` distinct pixels of frame ``frame`` that the check compares,
    drawn from (seed, frame)."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, int(frame)])
    return np.sort(rng.choice(n_pix, size=k, replace=False)).astype(np.int64)


def start_logits(shape, seed, traffic, device):
    """A fit's start: density logits drawn on ``device`` from the seed,
    N(start_logit_mean, start_logit_std) per cell."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return (torch.randn(tuple(shape), generator=gen, device=device)
            * float(traffic["start_logit_std"]) + float(traffic["start_logit_mean"]))
