"""Port parity, the whole-path integrator: ``integrate(rays, keys)`` of the
port's ``integrators/megakernel.py`` against the JAX package's fused kernel
on the same scenes, rays and path keys.

The JAX side runs its Pallas kernel in interpret mode (``interpret=True,
force=True``, as ``tests/test_megakernel.py`` does). The port runs on CPU
tensors with ``force=True``, where each wrapper takes its kernel's plain
version: the wavefront bounce over the matmul-form sweep. The CUDA kernels
themselves are held against these same plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from xraytracer_tpu.geometry import Rays as JRays
from xraytracer_tpu.integrators.megakernel import (
    try_make_fused_path_integrator as j_try_fused,
)
from xraytracer_tpu.sampling import path_keys as j_path_keys
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu_torch.geometry import Rays
from xraytracer_tpu_torch.integrators import make_path_integrator
from xraytracer_tpu_torch.integrators import megakernel as mk
from xraytracer_tpu_torch.sampling import rng
from xraytracer_tpu_torch.scene import builder as tbuilder
from xraytracer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

# Both sides draw the same numbers and make the same discrete decisions, so
# what is left is float32 rounding: the Pallas kernel tests hits in its
# 10-feature matmul form and takes sin / cos from the interpreter, the port
# uses its own matmul-form sweep and PyTorch's sin / cos. Radiance here is
# O(1) (Le up to 40), so this is a few ulp. The JAX package's own
# fused-vs-wavefront gates are 10x to 100x wider (rtol 2e-3 / atol 2e-3 on
# Cornell, 2e-4 / 2e-5 on the 64-light room).
GATE = dict(rtol=2e-5, atol=2e-6)


def _rays_and_keys(n, seed=0):
    """Random rays from a point near the Cornell camera toward the box, and
    the path keys of ``path_keys(7, arange(n), 0)``, as numpy."""
    g = np.random.default_rng(seed)
    o = np.tile(np.array([278.0, 273.0, -600.0], np.float32), (n, 1))
    d = np.stack(
        [g.uniform(-0.45, 0.45, n), g.uniform(-0.45, 0.45, n), np.ones(n)],
        axis=-1,
    ).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _jax_radiance(fused, o, d):
    import jax.numpy as jnp

    n = o.shape[0]
    keys = j_path_keys(7, jnp.arange(n, dtype=jnp.uint32), 0)
    return np.asarray(fused(JRays(o=jnp.asarray(o), d=jnp.asarray(d)), keys))


def _port_radiance(fused, o, d):
    n = o.shape[0]
    keys = rng.path_keys(7, torch.arange(n), 0)
    rays = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    return fused(rays, keys).numpy()


@pytest.fixture(scope="module")
def cornell():
    jt = jpresets.build_cornell_box().build()
    tt = tpresets.build_cornell_box().build(device="cpu")
    return (jt, jbuilder.scene_statics(jt)), (tt, tbuilder.scene_statics(tt))


def _many_light_builder(mod, n_side=8, face_in=False):
    """Room with an n_side^2 grid of small ceiling quad lights of skewed
    powers (the scene of the JAX package's many-light test). As wound there
    the floor and the back wall face out of the room, so next-event
    estimation adds nothing; ``face_in`` winds both to face the lights,
    which puts every light pick and shadow test to work."""
    b = mod.SceneBuilder()
    white = b.add_lambert((0.7, 0.7, 0.7))
    quads = []
    for k, (v0, v1, v2, v3) in enumerate((
        ((0, 0, 0), (556, 0, 0), (556, 0, 559), (0, 0, 559)),
        ((0, 0, 559), (556, 0, 559), (556, 548, 559), (0, 548, 559)),
        ((0, 548, 0), (556, 548, 0), (556, 548, 559), (0, 548, 559)),
    )):
        if face_in and k < 2:
            v1, v3 = v3, v1
        quads.append(np.asarray([[v0, v1, v2], [v0, v2, v3]], np.float32))
    b.add_mesh(np.concatenate(quads, axis=0), material=white)
    g = np.random.default_rng(11)
    for i in range(n_side):
        for j in range(n_side):
            x0 = 40.0 + i * 60.0
            z0 = 40.0 + j * 60.0
            power = float(g.uniform(0.5, 40.0))
            b.add_quad_light(
                (x0, 547.0, z0), (x0 + 30.0, 547.0, z0),
                (x0, 547.0, z0 + 30.0), (power,) * 3,
            )
    return b


@pytest.mark.parametrize("nee,cosine", [(True, False), (True, True),
                                        (False, False)])
def test_integrate_matches_jax_fused_kernel(cornell, nee, cosine):
    (jt, jst), (tt, tst) = cornell
    jf = j_try_fused(jt, jst, max_depth=3, nee=nee, cosine_sampling=cosine,
                     interpret=True, force=True)
    tf = mk.try_make_fused_path_integrator(
        tt, tst, max_depth=3, nee=nee, cosine_sampling=cosine, force=True)
    assert jf is not None and tf is not None
    o, d = _rays_and_keys(1024)
    mk.reset_counts()
    got = _port_radiance(tf, o, d)
    # CPU tensors: the plain version ran, no kernel was launched
    assert mk.counts()["mega_path"] == {"launches": 0, "plain_calls": 1}
    want = _jax_radiance(jf, o, d)
    assert got.shape == (1024, 3) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **GATE)
    assert got.mean() > 1e-3  # the scene is lit
    # and the port's fused entry point is its wavefront route, draw for draw
    wave = make_path_integrator(tt, tst, 3, nee=nee, cosine_sampling=cosine,
                                fused="never")
    keys = rng.path_keys(7, torch.arange(1024), 0)
    rays = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    np.testing.assert_allclose(got, wave(rays, keys).numpy(), **GATE)


def test_integrate_ragged_ray_count(cornell):
    """A ray count that is no multiple of any tile: 4096 + 513."""
    (jt, jst), (tt, tst) = cornell
    jf = j_try_fused(jt, jst, max_depth=2, nee=True, interpret=True, force=True)
    tf = mk.try_make_fused_path_integrator(tt, tst, max_depth=2, nee=True,
                                           force=True)
    n = 4096 + 513
    o, d = _rays_and_keys(n, seed=5)
    got = _port_radiance(tf, o, d)
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got, _jax_radiance(jf, o, d), **GATE)


@pytest.mark.parametrize("face_in", [False, True], ids=["as_wound", "face_in"])
@pytest.mark.parametrize("nee_mode", ["one", "power"])
def test_integrate_many_lights(nee_mode, face_in):
    """64 lights: one light per vertex, picked uniformly or by power. A pick
    that flipped would move a pixel by a whole light's contribution."""
    jt = _many_light_builder(jbuilder, face_in=face_in).build()
    tt = _many_light_builder(tbuilder, face_in=face_in).build(device="cpu")
    jst, tst = jbuilder.scene_statics(jt), tbuilder.scene_statics(tt)
    assert jst["n_area_lights"] == tst["n_area_lights"] == 64
    kw = dict(max_depth=3 if face_in else 2, nee=True, cosine_sampling=True,
              nee_mode=nee_mode, force=True)
    jf = j_try_fused(jt, jst, interpret=True, **kw)
    tf = mk.try_make_fused_path_integrator(tt, tst, **kw)
    assert jf is not None and tf is not None
    o, d = _rays_and_keys(1024)
    got = _port_radiance(tf, o, d)
    np.testing.assert_allclose(got, _jax_radiance(jf, o, d), **GATE)
    assert got.max() > 0.1  # lights contribute
    if face_in:
        # next-event estimation reaches the floor and the wall: most lanes
        # carry light that no emitter hit explains
        o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
        keys = rng.path_keys(7, torch.arange(1024), 0)
        no_nee = mk.try_make_fused_path_integrator(
            tt, tst, **dict(kw, nee=False, le_depth0_only=True))
        direct = no_nee(Rays(o=o_t, d=d_t), keys).numpy()
        assert ((got > 0).any(axis=-1) & ~(direct > 0).any(axis=-1)).mean() > 0.3


def _sphere_scene():
    b = tbuilder.SceneBuilder()
    b.add_sphere(center=(0, 0, 0), radius=1.0)
    return b.build(device="cpu")


def _big_mesh_scene():
    """48 x 44 x 2 = 4224 triangles: over the 4096-row gate."""
    b = tbuilder.SceneBuilder()
    white = b.add_lambert((0.8, 0.8, 0.8))
    b.add_sphere_mesh((0.0, 0.0, 0.0), 1.0, 48, 44, material=white)
    b.add_quad_light((-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (-1.0, 3.0, 1.0),
                     (10.0, 10.0, 10.0))
    return b.build(device="cpu")


def _mirror_scene():
    b = tbuilder.SceneBuilder()
    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]] * 8, np.float32)
    b.add_mesh(tri, material=b.add_mirror())
    return b.build(device="cpu")


@pytest.mark.parametrize("case", [
    "sphere", "depth_9", "depth_0", "over_4096_rows", "9_lights_all",
    "65_lights_one", "mirror", "unknown_nee_mode",
])
def test_eligibility_gates(cornell, case):
    """What ``_eligible`` refuses comes back as None, so that the wavefront
    route takes over; the same gates as the JAX package's."""
    _, (tt, tst) = cornell
    kw = dict(max_depth=3, force=True)
    if case == "sphere":
        scene = _sphere_scene()
    elif case == "depth_9":
        scene, kw = tt, dict(max_depth=9, force=True)
    elif case == "depth_0":
        scene, kw = tt, dict(max_depth=0, force=True)
    elif case == "over_4096_rows":
        scene = _big_mesh_scene()
        assert scene.tri_v0.shape[0] > mk.MAX_TRIANGLES
    elif case == "9_lights_all":
        scene = _many_light_builder(tbuilder, n_side=3).build(device="cpu")
        # the same nine lights qualify for a single pick
        assert mk.try_make_fused_path_integrator(
            scene, tbuilder.scene_statics(scene), nee_mode="one", **kw
        ) is not None
    elif case == "65_lights_one":
        b = _many_light_builder(tbuilder, n_side=8)
        b.add_quad_light((0, 547.0, 0), (10, 547.0, 0), (0, 547.0, 10), (1.0,) * 3)
        scene, kw = b.build(device="cpu"), dict(kw, nee_mode="one")
    elif case == "mirror":
        scene = _mirror_scene()
    else:
        scene, kw = tt, dict(kw, nee_mode="some")
    st = tbuilder.scene_statics(scene)
    assert mk.try_make_fused_path_integrator(scene, st, **kw) is None


def test_cpu_tables_route_to_the_wavefront_unless_forced(cornell):
    """Without ``force`` tables on the CPU never reach the fused entry
    points: ``fused="auto"`` is the wavefront route there."""
    _, (tt, tst) = cornell
    assert mk.try_make_fused_path_integrator(tt, tst, max_depth=3) is None
    auto = make_path_integrator(tt, tst, 3, nee=True)
    assert not hasattr(auto, "fused_spec")
    assert mk.try_make_fused_path_integrator(tt, tst, max_depth=3,
                                             force=True) is not None


def test_light_table_and_masks(cornell):
    """``_bake``: one row per light in the kernel's layout, the pick
    probabilities, and the masks of valid and blocking rows."""
    _, (tt, tst) = cornell
    fs = mk._bake(tt, tst, 3, True, True, False, nee_mode="power")
    assert fs.n_lights == 1 and fs.lights.shape == (1, mk.LIGHT_STRIDE)
    row = fs.lights[0].numpy()
    assert row[0] == float(tt.al_type[0])
    for col, name in ((1, "v0"), (4, "e1"), (7, "e2"), (10, "ng"), (13, "le")):
        np.testing.assert_array_equal(
            row[col:col + 3], getattr(tt, "al_" + name)[0].numpy())
    assert row[16] == 1.0
    np.testing.assert_array_equal(fs.pick_cdf.numpy(), [0.0, 1.0])
    valid = (tt.tri_obj >= 0).numpy()
    np.testing.assert_array_equal(fs.valid.numpy().astype(bool), valid)
    # the two triangles of the ceiling light do not block shadow rays
    assert int(fs.valid.sum()) - int(fs.blocks.sum()) == 2
    # uniform pick over n lights
    room = _many_light_builder(tbuilder).build(device="cpu")
    fs = mk._bake(room, tbuilder.scene_statics(room), 2, True, True, True,
                  nee_mode="one")
    np.testing.assert_array_equal(fs.lights[:, 16].numpy(),
                                  np.full(64, np.float32(1.0 / 64)))
    # no lights: next-event estimation is switched off
    dark = _mirror_scene()
    assert mk._eligible(dark, tbuilder.scene_statics(dark), 3) is None
    b = tbuilder.SceneBuilder()
    b.add_mesh(np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]] * 8, np.float32),
               material=b.add_lambert((0.5, 0.5, 0.5)))
    unlit = b.build(device="cpu")
    fs = mk._bake(unlit, tbuilder.scene_statics(unlit), 3, True, True, False)
    assert fs is not None and fs.n_lights == 0 and fs.nee is False


def test_key_bits_round_trip():
    """uint32 keys held in int64 reach the kernels as the same 32 bits."""
    keys = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], dtype=torch.int64)
    bits = mk._i32_bits(keys)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), keys.numpy())


def test_wrappers_raise_on_bad_inputs_without_a_card(cornell):
    """Input checks need no card: rays that lie on another device than the
    scene are refused before anything is launched."""
    _, (tt, tst) = cornell
    tf = mk.try_make_fused_path_integrator(tt, tst, max_depth=3, force=True)
    rays = Rays(o=torch.zeros((4, 3), device="meta"),
                d=torch.zeros((4, 3), device="meta"))
    with pytest.raises(ValueError, match="rays on"):
        tf(rays, torch.zeros(4, dtype=torch.int64))
