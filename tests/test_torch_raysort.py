"""Port parity, bounce-ray coherence sorting: the port's
``geometry/raysort.py`` and ``make_path_integrator(sort_rays=...)`` against
the JAX package's, and the ports of
``tests/test_integrators.py::test_sorted_wavefront_bitwise_identical`` and
``test_sorted_wavefront_stats_match`` (same scene, frame, samples and
depths).

Sorting is lane scheduling: every per-lane quantity travels with its lane
and the radiance is scattered back to lane order, so the image and the
counters must be BITWISE those of the unsorted route. On the CPU the sweeps
are their plain versions; ``chip_smoke.py`` (``mesh_path``) holds the
sorted and unsorted images bitwise on the card, through the sweep kernels.
"""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_slice import GATE

from xraytracer_tpu.camera import PinholeCamera as JCamera
from xraytracer_tpu.geometry import raysort as j_raysort
from xraytracer_tpu.integrators import make_path_integrator as j_make_path
from xraytracer_tpu.renderer import render as j_render
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.geometry import raysort
from xraytracer_tpu_torch.integrators import make_path_integrator
from xraytracer_tpu_torch.renderer import render
from xraytracer_tpu_torch.scene import builder as tbuilder

torch.set_num_threads(1)

W, H, SPP, SEED = 40, 30, 2, 3  # tests/test_integrators.py's frame and draws
C2W = np.asarray(
    [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0], [0, 0.6, 4.0, 1]],
    np.float32,
)


def _sphere_mesh_scene(mod):
    """tests/test_integrators.py's ``_sphere_mesh_scene`` through either
    package's builder: a 17x16 lat-long sphere mesh, a floor, a quad light."""
    b = mod.SceneBuilder()
    white = b.add_lambert((0.8, 0.8, 0.8))
    b.add_sphere_mesh((0.0, 0.0, 0.0), 1.0, 17, 16, material=white)
    floor = np.asarray(
        [[[-4, -1, -4], [4, -1, -4], [4, -1, 4]],
         [[-4, -1, -4], [4, -1, 4], [-4, -1, 4]]], np.float32,
    )
    b.add_mesh(floor, material=white)
    b.add_quad_light((-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (-1.0, 3.0, 1.0),
                     (10.0, 10.0, 10.0))
    return b


def _port():
    tables = _sphere_mesh_scene(tbuilder).build(device="cpu")
    cam = PinholeCamera.make(W / H, c2w=C2W, fov_deg=45.0, device="cpu")
    return tables, tbuilder.scene_statics(tables), cam


def test_coherence_key_and_bounds_bitwise_jax():
    """``scene_bounds`` on the same scene and ``coherence_key`` on seeded
    random rays (origins inside and outside the bounds, every octant, a
    third of the lanes dead) bitwise the JAX package's."""
    jt = _sphere_mesh_scene(jbuilder).build()
    tt = _port()[0]
    j_lo, j_hi = (np.asarray(x) for x in j_raysort.scene_bounds(jt))
    lo, hi = raysort.scene_bounds(tt)
    np.testing.assert_array_equal(lo.numpy(), j_lo)
    np.testing.assert_array_equal(hi.numpy(), j_hi)

    rng = np.random.default_rng(0)
    n = 4099
    o = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:7] = [[0.0, -1.0, 0.0]] * 7  # a zero component in the octant test
    active = rng.random(n) > 0.33
    j_ext = jnp.maximum(jnp.asarray(j_hi) - jnp.asarray(j_lo), 1e-30)
    ext = torch.clamp(hi - lo, min=1e-30)
    np.testing.assert_array_equal((1.0 / ext).numpy(), np.asarray(1.0 / j_ext))
    want = np.asarray(j_raysort.coherence_key(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(active), jnp.asarray(j_lo),
        1.0 / j_ext))
    got = raysort.coherence_key(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(active), lo, 1.0 / ext)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~active] == 0x7FFFFFFF).all()


def test_sorted_wavefront_bitwise_identical():
    """Sorting forced on vs off, depth 3 with NEE (shadow rays parked) and
    depth 9 without: ``assert_array_equal``."""
    tables, st, cam = _port()
    for depth, nee in ((3, True), (9, False)):
        imgs = []
        for sort in (False, True):
            integ = make_path_integrator(
                tables, st, max_depth=depth, nee=nee, cosine_sampling=True,
                fused="never", sort_rays=sort,
            )
            imgs.append(render(tables, cam, integ, W, H, SPP, seed=SEED).image)
        np.testing.assert_array_equal(imgs[0], imgs[1])


def test_sorted_wavefront_stats_match():
    """with_stats counters are permutation-invariant sums."""
    tables, st, cam = _port()
    outs = []
    for sort in (False, True):
        integ = make_path_integrator(
            tables, st, max_depth=3, nee=True, with_stats=True,
            fused="never", sort_rays=sort,
        )
        outs.append(render(tables, cam, integ, W, H, SPP, seed=SEED).stats)
    assert set(outs[0]) == set(outs[1])
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert outs[0]["rays"][1] > 0


def test_sorted_render_matches_jax_sorted_render():
    """The port's sorted wavefront against the JAX package's sorted
    wavefront (depth 3, NEE, cosine sampling), at test_torch_slice.GATE."""
    tables, st, cam = _port()
    tr = render(tables, cam, make_path_integrator(
        tables, st, 3, nee=True, cosine_sampling=True, fused="never",
        sort_rays=True), W, H, SPP, seed=SEED)
    jt = _sphere_mesh_scene(jbuilder).build()
    jr = j_render(jt, JCamera.make(W / H, c2w=C2W, fov_deg=45.0), j_make_path(
        jt, jbuilder.scene_statics(jt), 3, nee=True, cosine_sampling=True,
        fused="never", sort_rays=True), W, H, SPP, seed=SEED)
    assert tr.n_rejected == jr.n_rejected == 0
    np.testing.assert_allclose(tr.image, jr.image, **GATE)
    assert tr.image.mean() > 0.01
