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


def pixel_strata(config):
    """The frame's pixel ids (sorted) by what the ray through each pixel's
    centre meets first: ``lights`` (a sphere light), ``media`` (a medium's
    box), ``rest`` (neither). Worked out in float64 from the configuration's
    camera and scene, as ``reference/common.py`` builds the camera, not
    from an image; for scenes of media and sphere lights alone."""
    sc = config["scene"]
    if set(sc) - {"density_grid", "media", "sphere_lights"}:
        raise ValueError("pixel strata are worked out for media and sphere lights alone")
    r, cam = config["render"], config["camera"]
    w, h = int(r["width"]), int(r["height"])
    ids = np.arange(w * h, dtype=np.int64)
    scale = np.tan(0.5 * np.radians(float(cam["fov_deg"])))
    su, sv = (ids % w + 0.5) / w, (ids // w + 0.5) / h
    local = np.stack([(2.0 * su - 1.0) * scale, (1.0 - 2.0 * sv) * scale * h / w,
                      -np.ones(w * h)], axis=-1)
    c2w = np.asarray(cam["c2w"], np.float64).reshape(4, 4)
    d = local @ c2w[:3, :3]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = c2w[3, :3]
    t_light = np.full(w * h, np.inf)
    for light in sc.get("sphere_lights", []):
        oc = o - np.asarray(light["center"], np.float64)
        b = d @ oc
        disc = b * b - (oc @ oc - float(light["radius"]) ** 2)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        t_light = np.where((disc > 0) & (t > 0), np.minimum(t_light, t), t_light)
    t_box = np.full(w * h, np.inf)
    inv = 1.0 / np.where(d == 0, 1e-300, d)
    for med in sc.get("media", []):
        box = sc["density_grid"] if med["kind"] == "heterogeneous" else med
        t0 = (np.asarray(box["bmin"], np.float64) - o) * inv
        t1 = (np.asarray(box["bmax"], np.float64) - o) * inv
        near = np.maximum(np.minimum(t0, t1).max(-1), 0.0)
        far = np.maximum(t0, t1).min(-1)
        t_box = np.where(far >= near, np.minimum(t_box, near), t_box)
    lights = t_light < t_box
    media = np.isfinite(t_box) & ~lights
    return {"lights": ids[lights], "media": ids[media], "rest": ids[~lights & ~media]}


def frame_pixels(config, strata, seed, frame):
    """The pixels of frame ``frame`` that the check compares, drawn from
    (seed, frame): ``check.pixels_per_frame`` over the whole frame, or, where
    the configuration has ``check.strata``, that many from each stratum of
    ``strata`` (``pixel_strata``; all of a stratum that holds fewer)."""
    chk = config["check"]
    if "strata" not in chk:
        r = config["render"]
        return checked_pixels(seed, frame, int(r["width"]) * int(r["height"]),
                              int(chk["pixels_per_frame"]))
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, int(frame)])
    out = [rng.choice(strata[name], size=min(int(k), len(strata[name])), replace=False)
           for name, k in sorted(chk["strata"].items())]
    return np.sort(np.concatenate(out)).astype(np.int64)


def count_pixels(config):
    """The fixed pixels a configuration's ``count`` tallies the work of a
    frame over: every ``stride``-th pixel of every ``stride``-th row."""
    r, s = config["render"], int(config["count"]["stride"])
    w, h = int(r["width"]), int(r["height"])
    rows, cols = np.meshgrid(np.arange(0, h, s), np.arange(0, w, s), indexing="ij")
    return (rows * w + cols).reshape(-1).astype(np.int64)


def start_logits(shape, seed, traffic, device):
    """A fit's start: density logits drawn on ``device`` from the seed,
    N(start_logit_mean, start_logit_std) per cell."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return (torch.randn(tuple(shape), generator=gen, device=device)
            * float(traffic["start_logit_std"]) + float(traffic["start_logit_mean"]))
