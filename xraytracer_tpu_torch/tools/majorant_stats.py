"""Majorant-quality analysis for a density grid: expected null-collision
candidate counts per chord under block-max supergrids.

Null-collision tracking (delta/ratio) draws one density evaluation per
majorant-optical-depth unit, so the integral of the LOCAL majorant along a
chord — versus the integral of the true density — is the work model for
the tracking kernels (``csrc/media.cuh``; the JAX package's
media_pallas.py). This tool Monte-Carlo
estimates, for random chords through the grid box:

  * true optical line integral (the intrinsic lower bound),
  * block-MAX majorant integral at a given supergrid size (current cost),
  * residual (max - min) integral (what residual ratio tracking would
    walk, with the min handled analytically).

The PyTorch port's copy of ``xraytracer_tpu/tools/majorant_stats.py``,
numpy only: the procedural default comes from the port's
``scene/presets.py``.

Usage:
    python -m xraytracer_tpu_torch.tools.majorant_stats --grid cloud.npy --nb 8 16
    python -m xraytracer_tpu_torch.tools.majorant_stats            # procedural
"""

import argparse

import numpy as np


def block_tables(dens, nb):
    """(max, min) block tables over an ``nb^3`` partition with a one-cell
    overlap ring (bounds every trilinear lookup inside the block, matching
    scene.builder.supergrid_max)."""
    res = dens.shape
    bs = np.array(res, np.float64) / nb
    mx = np.zeros((nb, nb, nb), np.float32)
    mn = np.zeros((nb, nb, nb), np.float32)
    for i in range(nb):
        x0, x1 = int(i * bs[0]), min(int(np.ceil((i + 1) * bs[0])) + 1, res[0])
        for j in range(nb):
            y0, y1 = int(j * bs[1]), min(int(np.ceil((j + 1) * bs[1])) + 1,
                                         res[1])
            for k in range(nb):
                z0, z1 = int(k * bs[2]), min(
                    int(np.ceil((k + 1) * bs[2])) + 1, res[2]
                )
                blk = dens[x0:x1, y0:y1, z0:z1]
                mx[i, j, k] = blk.max()
                mn[i, j, k] = blk.min()
    return mx, mn


def chord_integrals(dens, nb, n_chords=2000, n_samples=256, seed=0):
    """Mean (true, max-majorant, residual) line integrals over random
    chords, in candidate counts per unit sigma_t (multiply by sigma_t and
    the world-to-index scale for absolute counts)."""
    res = np.array(dens.shape)
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(0, 1, (n_chords, 3)) * (res - 1)
    p2 = rng.uniform(0, 1, (n_chords, 3)) * (res - 1)
    ts = np.linspace(0.0, 1.0, n_samples)
    pts = p1[:, None, :] + (p2 - p1)[:, None, :] * ts[None, :, None]
    L = np.linalg.norm(p2 - p1, axis=-1)
    ic = np.clip(pts, 0, res - 1 - 1e-4)

    mx, mn = block_tables(dens, nb)
    bs = (res - 1.0) / nb
    bidx = np.clip((ic / bs).astype(int), 0, nb - 1)
    m_line = mx[bidx[..., 0], bidx[..., 1], bidx[..., 2]]
    n_line = mn[bidx[..., 0], bidx[..., 1], bidx[..., 2]]

    i0 = ic.astype(int)
    f = ic - i0
    i1 = np.minimum(i0 + 1, res - 1)

    def corner(ix, iy, iz):
        return dens[ix[..., 0], iy[..., 1], iz[..., 2]]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    tri = (
        (corner(i0, i0, i0) * (1 - fx) + corner(i1, i0, i0) * fx) * (1 - fy)
        + (corner(i0, i1, i0) * (1 - fx) + corner(i1, i1, i0) * fx) * fy
    ) * (1 - fz) + (
        (corner(i0, i0, i1) * (1 - fx) + corner(i1, i0, i1) * fx) * (1 - fy)
        + (corner(i0, i1, i1) * (1 - fx) + corner(i1, i1, i1) * fx) * fy
    ) * fz

    return dict(
        true=float((tri.mean(axis=1) * L).mean()),
        max_majorant=float((m_line.mean(axis=1) * L).mean()),
        residual=float(((m_line - n_line).mean(axis=1) * L).mean()),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--grid", default=None,
                   help=".npy/.npz dense grid (default: procedural cloud)")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--nb", type=int, nargs="+", default=[8, 16])
    a = p.parse_args(argv)
    if a.grid:
        dens = np.load(a.grid)
        if hasattr(dens, "files"):
            dens = dens[dens.files[0]]
        dens = np.asarray(dens, np.float32)
    else:
        from ..scene.presets import procedural_cloud

        dens = np.asarray(procedural_cloud((a.res,) * 3), np.float32)
    print(f"grid {dens.shape}: mean {dens.mean():.3f} max {dens.max():.3f} "
          f"occupancy {(dens > 0).mean():.3f}")
    for nb in a.nb:
        r = chord_integrals(dens, nb)
        eff = r["true"] / max(r["max_majorant"], 1e-12)
        print(
            f"supergrid {nb}^3: candidates/chord — max {r['max_majorant']:.2f}"
            f"  residual {r['residual']:.2f}  true {r['true']:.2f}"
            f"  (majorant efficiency {eff:.0%})"
        )


if __name__ == "__main__":
    main()
