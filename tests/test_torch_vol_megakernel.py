"""Port parity, the whole-path homogeneous volume integrator: the port's
``integrators/vol_megakernel.py`` against the JAX package's fused volume
kernel on the ``vpt`` scene, same rays, keys and pixels.

The JAX side runs its Pallas kernel in interpret mode (``interpret=True,
force=True``, as ``tests/test_megakernel.py`` does). The port runs on CPU
tensors with ``force=True``, where each wrapper takes its kernel's plain
version: the wavefront volume integrator over the matmul-form sweep. The
CUDA kernels themselves are held against these same plain versions on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xraytracer_tpu.camera import PinholeCamera as JCamera
from xraytracer_tpu.geometry import Rays as JRays
from xraytracer_tpu.integrators import vol_megakernel as jvm
from xraytracer_tpu.sampling import path_keys as j_path_keys
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.geometry import Rays
from xraytracer_tpu_torch.integrators import make_volume_integrator
from xraytracer_tpu_torch.integrators import vol_megakernel as vm
from xraytracer_tpu_torch.renderer import WavefrontRenderer
from xraytracer_tpu_torch.sampling import rng
from xraytracer_tpu_torch.scene import builder as tbuilder
from xraytracer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

W, H = 24, 18
# Both sides draw the same numbers and make the same decisions; what is left
# is float32 rounding: the Pallas kernel tests triangles in the classic form
# and takes exp / log / sin / cos from the interpreter, the port's plain
# version sweeps in matmul form and uses PyTorch's. Radiance is O(1) (Le 10).
# The gate of tests/test_torch_megakernel.py; the JAX package's own
# fused-vs-wavefront gate here is rtol 2e-3 / atol 2e-3.
GATE = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module")
def vpt():
    jt = jpresets.build_vpt_scene().build()
    tt = tpresets.build_vpt_scene().build(device="cpu")
    return (jt, jbuilder.scene_statics(jt)), (tt, tbuilder.scene_statics(tt))


@pytest.fixture(scope="module")
def cameras():
    return (JCamera.make(W / H, **jpresets.preset_vpt()[1]),
            PinholeCamera.make(W / H, device="cpu",
                               **tpresets.preset_vpt(device="cpu")[1]))


def _rays(n, seed=11):
    g = np.random.default_rng(seed)
    o = np.tile(np.array([0.0, 0.0, 5.0], np.float32), (n, 1))
    d = np.stack([g.uniform(-0.3, 0.3, n), g.uniform(-0.3, 0.3, n),
                  -np.ones(n)], axis=-1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("variant", ["mis", "achromatic", "nomis"])
@pytest.mark.parametrize("nee", [False, True], ids=["vpt", "vpt_nee"])
def test_integrate_matches_jax_fused_kernel(nee, variant):
    jt = jpresets.build_vpt_scene(variant).build()
    tt = tpresets.build_vpt_scene(variant).build(device="cpu")
    jst, tst = jbuilder.scene_statics(jt), tbuilder.scene_statics(tt)
    jf = jvm.try_make_fused_volume_integrator(
        jt, jst, max_depth=4, nee=nee, interpret=True, force=True)
    tf = vm.try_make_fused_volume_integrator(tt, tst, max_depth=4, nee=nee,
                                             force=True)
    assert jf is not None and tf is not None
    n = W * H
    o, d = _rays(n)
    want = np.asarray(jf(JRays(o=jnp.asarray(o), d=jnp.asarray(d)),
                         j_path_keys(5, jnp.arange(n, dtype=jnp.uint32), 0)))
    keys = rng.path_keys(5, torch.arange(n), 0)
    rays = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    vm.reset_counts()
    got = tf(rays, keys).numpy()
    # CPU tensors: the plain version ran, no kernel was launched
    assert vm.counts()["vol_path"] == {"launches": 0, "plain_calls": 1}
    assert got.shape == (n, 3) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **GATE)
    assert got.mean() > 1e-3
    # and the fused entry point is the port's wavefront route, draw for draw
    wave = make_volume_integrator(tt, tst, 4, nee=nee, fused="never")
    np.testing.assert_allclose(got, wave(rays, keys).numpy(), **GATE)


@pytest.mark.parametrize("persistent", [False, True], ids=["per_sample", "persistent"])
def test_spp_render_matches_jax(vpt, cameras, persistent):
    """``render_chunk`` against the JAX whole-render kernel, with a resumed
    chunk and equal reject counts."""
    (jt, jst), (tt, tst) = vpt
    jcam, tcam = cameras
    kw = dict(seed=2, max_depth=3, nee=True, persistent=persistent, force=True)
    jr = jvm.try_make_fused_volume_spp_render(jt, jst, jcam, W, H,
                                              interpret=True, **kw)
    tr = vm.try_make_fused_volume_spp_render(tt, tst, tcam, W, H, **kw)
    assert jr is not None and tr is not None
    name = "vol_spp_persistent" if persistent else "vol_spp"
    vm.reset_counts()
    for s0, n_spp in ((0, 2), (2, 1)):
        jrad, jrej = jr(s0, n_spp)
        trad, trej = tr(s0, n_spp)
        np.testing.assert_allclose(trad.numpy(), np.asarray(jrad)[:W * H], **GATE)
        assert int(trej) == int(jrej) == 0
    assert vm.counts()[name] == {"launches": 0, "plain_calls": 2}
    assert tr.n_pad == W * H and tr.pixel_order == "raster"
    assert float(trad.sum()) > 0.0


def test_per_sample_and_persistent_agree_and_morton_is_raster(vpt, cameras):
    (_, _), (tt, tst) = vpt
    _, tcam = cameras
    kw = dict(seed=2, max_depth=4, nee=True, force=True)
    out = {}
    for persistent in (False, True):
        for order in ("raster", "morton"):
            rc = vm.try_make_fused_volume_spp_render(
                tt, tst, tcam, W, H, persistent=persistent, pixel_order=order, **kw)
            rad, rej = rc(0, 3)
            img = np.empty((W * H, 3), np.float32)
            img[rc.pixel_ids] = rad.numpy()
            out[persistent, order] = (img, int(rej))
    ref = out[True, "raster"]
    for key, (img, rej) in out.items():
        np.testing.assert_array_equal(img, ref[0], err_msg=str(key))
        assert rej == ref[1]


def test_plain_version_batches_samples_bitwise(vpt, cameras):
    """The plain spp versions trace ``batch`` samples of every lane as one
    wavefront; the sums are those of the sample-by-sample loop, bit for bit."""
    (_, _), (tt, tst) = vpt
    _, tcam = cameras
    rc = vm.try_make_fused_volume_spp_render(tt, tst, tcam, W, H, seed=2,
                                             max_depth=3, nee=True, force=True)
    vc = vm._vol_consts(tt, tst, 3, True, None, None)
    one_stats, two_stats = {}, {}
    rad1, rej1 = vm.vol_spp_plain(vc, rc.view, 1, 3, one_stats)
    rad2, rej2 = vm.vol_spp_persistent_plain(vc, rc.view, 1, 3, two_stats, batch=2)
    assert float(rad1.sum()) > 0.0
    assert torch.equal(rad2, rad1) and torch.equal(rej2, rej1)
    for k, v in one_stats.items():
        assert torch.equal(two_stats[k], v), k


@pytest.mark.parametrize("case", [
    "9_triangles", "sphere", "two_boxes", "heterogeneous_box", "5_lights",
    "depth_65", "depth_0", "smooth_normals", "sphere_light",
])
def test_eligibility_refusals(vpt, case):
    """What ``_eligible_volume`` refuses comes back as None, so that the
    wavefront route takes over; the same gates as the JAX package's."""
    b = tpresets.build_vpt_scene()
    depth = 4
    tri = np.asarray([[[2, 0, 0], [3, 0, 0], [2, 1, 0]]], np.float32)
    if case == "9_triangles":
        b.add_mesh(np.repeat(tri, 7, axis=0), material=b.add_lambert((0.5,) * 3))
    elif case == "sphere":
        b.add_sphere((3.0, 0.0, 0.0), 0.5, material=b.add_lambert((0.5,) * 3))
    elif case == "two_boxes":
        b.add_homogeneous_medium(0.0, (0.5,) * 3, (0.5,) * 3, (2, 2, 2), (3, 3, 3))
    elif case == "heterogeneous_box":
        b = tpresets.build_volume_scene(res=(8, 8, 8))
    elif case == "5_lights":
        for k in range(4):
            b.add_quad_light((3.0 + k, 0, 0), (3.5 + k, 0, 0), (3.0 + k, 0, 0.5),
                             (1.0,) * 3)
    elif case == "depth_65":
        depth = 65
    elif case == "depth_0":
        depth = 0
    elif case == "smooth_normals":
        n = np.asarray([[[0, 0, 1], [0, 0.6, 0.8], [0.6, 0, 0.8]]], np.float32)
        b.add_mesh(tri, n, material=b.add_lambert((0.5,) * 3))
    elif case == "sphere_light":
        b.add_sphere_light((0.0, 4.0, 0.0), 0.5, (5.0,) * 3)
    scene = b.build(device="cpu")
    st = tbuilder.scene_statics(scene)
    assert vm.try_make_fused_volume_integrator(scene, st, depth, force=True) is None
    if case == "9_triangles":
        # one triangle fewer qualifies
        b2 = tpresets.build_vpt_scene()
        b2.add_mesh(np.repeat(tri, 6, axis=0), material=b2.add_lambert((0.5,) * 3))
        s2 = b2.build(device="cpu")
        assert vm.try_make_fused_volume_integrator(
            s2, tbuilder.scene_statics(s2), depth, force=True) is not None


def test_launch_constants(vpt):
    """``_vol_consts``: the host arrays a launch carries, in the layout
    ``csrc/vol_megakernel.cu::scene_from`` reads."""
    _, (tt, tst) = vpt
    vc = vm._vol_consts(tt, tst, 10, True, None, None)
    fc, ic = np.asarray(list(vc.fc), np.float32), list(vc.ic)
    assert fc.size == 8 * 14 + 19 + 4 * 16
    assert ic == [2, 1, 0, 10, 22, 1, 8192, 8193]
    np.testing.assert_array_equal(fc[0:3], tt.tri_v0[0].numpy())
    np.testing.assert_array_equal(fc[9:12], tt.tri_n0[0].numpy())
    assert fc[12] == 0.0 and fc[13] == -1.0     # the light's quad: row 0, no material
    m = fc[8 * 14:]
    np.testing.assert_array_equal(m[0:6], [-1, -1, -1, 1, 1, 1])
    np.testing.assert_array_equal(m[13:16], [1.0, 1.0, 1.0])   # sigma_t
    np.testing.assert_array_equal(m[16:19], [0.5, 0.5, 0.5])   # albedo
    assert m[19] == 1.0                                        # a quad light
    np.testing.assert_array_equal(m[19 + 13:19 + 16], [10.0, 10.0, 10.0])
    # next-event estimation is switched off when there is no light
    b = tbuilder.SceneBuilder()
    b.add_homogeneous_medium(0.0, (0.5,) * 3, (0.5,) * 3, (-1, -1, -1), (1, 1, 1))
    dark = b.build(device="cpu")
    assert list(vm._vol_consts(dark, tbuilder.scene_statics(dark), 3, True,
                               None, None).ic)[5] == 0


def test_renderer_takes_the_fused_volume_route(vpt, cameras):
    """An integrator that carries ``fused_spec`` with ``kind="volume"`` is
    upgraded to one ``vol_spp_persistent`` call per chunk; the image is the
    wavefront route's up to the camera ray's rounding (the kernels multiply
    by a float32 1 / width where the wavefront route divides)."""
    (_, _), (tt, tst) = vpt
    _, tcam = cameras
    assert vm.try_make_fused_volume_integrator(tt, tst, 4) is None   # CPU tables
    fused = vm.try_make_fused_volume_integrator(tt, tst, 4, nee=True, force=True)
    fused.fused_spec = dict(kind="volume", scene=tt, statics=tst, max_depth=4,
                            nee=True, max_steps=None, n_iterations=None,
                            force=True)
    wave = make_volume_integrator(tt, tst, 4, nee=True)
    assert not hasattr(wave, "fused_spec")
    vm.reset_counts()
    a = WavefrontRenderer(tt, tcam, fused, W, H, seed=4).render(4, spp_chunk=2)
    assert vm.counts()["vol_spp_persistent"]["plain_calls"] == 2
    assert vm.counts()["vol_path"]["plain_calls"] == 0
    b = WavefrontRenderer(tt, tcam, wave, W, H, seed=4).render(4)
    assert a.n_rejected == b.n_rejected == 0
    diff = np.abs(a.image - b.image)
    beyond = (diff > 2e-5 + 2e-4 * np.abs(b.image)).any(axis=-1)
    # a ray that differs in its last bit may take another decision somewhere
    # along a path: at most 2 of the 432 pixels
    assert int(beyond.sum()) <= 2, int(beyond.sum())
    assert abs(a.image.mean() - b.image.mean()) < 1e-3 * b.image.mean()


def test_grad_sampling_keeps_the_wavefront_route(vpt, monkeypatch):
    """The whole-path homogeneous kernel has no grad-sampling estimator (the
    JAX kernel has no such branch either): under ``grad_sampling`` (and
    ``differentiable``) a ``vpt`` scene keeps the wavefront loop, which
    renders that estimator, instead of the default one, on the card as on
    the CPU."""
    (_, _), (tt, tst) = vpt
    orig = vm.try_make_fused_volume_integrator
    monkeypatch.setattr(vm, "try_make_fused_volume_integrator",
                        lambda *a, **k: orig(*a, force=True, **k))
    default = make_volume_integrator(tt, tst, 4, nee=True)
    assert default.fused_spec["kind"] == "volume"     # the route K6 takes
    o, d = _rays(256, seed=17)
    rays = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    keys = rng.path_keys(3, torch.arange(256), 0)
    for kw in (dict(grad_sampling=True), dict(differentiable=True)):
        integ = make_volume_integrator(tt, tst, 4, nee=True, **kw)
        assert not hasattr(integ, "fused_spec"), kw
        vm.reset_counts()
        got = integ(rays, keys)
        assert all(c["plain_calls"] == 0 for c in vm.counts().values())
        wave = make_volume_integrator(tt, tst, 4, nee=True, fused="never", **kw)
        np.testing.assert_array_equal(got.numpy(), wave(rays, keys).numpy())
    gs = make_volume_integrator(tt, tst, 4, nee=True, grad_sampling=True)(rays, keys)
    assert not torch.equal(gs, default(rays, keys))
