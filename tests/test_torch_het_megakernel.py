"""Port parity, the whole-path heterogeneous volume integrator: the port's
``integrators/het_megakernel.py`` against the JAX package's fused
heterogeneous kernel and its wavefront integrator on the cloud scenes of
``tests/test_het_megakernel.py``, same rays and keys.

The JAX kernel runs in interpret mode (``interpret=True, force=True``). The
port runs on CPU tensors with ``force=True``, where each wrapper takes its
kernel's plain version: the port's wavefront volume loop with the host-side
tracking loops over the matmul-form sweep. The CUDA kernels themselves are
held against these same plain versions on the card by ``chip_smoke.py``.
The grid is rounded to bfloat16 first, because the Pallas kernel samples
the bf16-rounded field and the port the float32 one.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xraytracer_tpu.geometry import Rays as JRays
from xraytracer_tpu.integrators import het_megakernel as jhk
from xraytracer_tpu.integrators import volume as jvolume
from xraytracer_tpu.media_pallas import round_bf16
from xraytracer_tpu.sampling import path_keys as j_path_keys
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.config import get_preset
from xraytracer_tpu_torch.geometry import Rays
from xraytracer_tpu_torch.integrators import het_megakernel as hk
from xraytracer_tpu_torch.integrators import make_volume_integrator
from xraytracer_tpu_torch.math import from_rows
from xraytracer_tpu_torch.renderer import WavefrontRenderer, render
from xraytracer_tpu_torch.sampling import rng
from xraytracer_tpu_torch.scene import builder as tbuilder
from xraytracer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

N = 1024
DEPTH = 4
MAX_STEPS = 24
# the gate of tests/test_het_megakernel.py: same draws and decisions, what
# is left is float32 rounding along each path (exp / log / sin / cos of two
# math libraries, the order of a few products)
GATE = dict(rtol=2e-4, atol=2e-5)
W, H = 16, 12
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "cloud_nee_24x18_4spp_seed0.npy")


def _cloud_builders(seed=3, scattering=(0.08, 0.07, 0.06), le=25.0):
    density = round_bf16(jpresets.procedural_cloud(res=(24, 20, 16), seed=seed))
    kw = dict(density=density, scattering=scattering,
              absorption=(0.02, 0.02, 0.02), le=le)
    return jpresets.build_volume_scene(**kw), tpresets.build_volume_scene(**kw)


def _eight_light_builders():
    """The 8-light cloud of tests/test_het_megakernel.py, built by both
    packages from the same numbers."""
    density = round_bf16(jpresets.procedural_cloud(res=(24, 20, 16), seed=4))
    bmin = np.array([-165.0, -110.0, -160.0], np.float32)
    bmax = np.array([165.0, 110.0, 160.0], np.float32)
    out = []
    for mod in (jbuilder, tbuilder):
        b = mod.SceneBuilder()
        b.set_density_grid(density, bmin, bmax)
        b.add_heterogeneous_medium(0.0, (0.02, 0.02, 0.02), (0.08, 0.07, 0.06))
        g = np.random.default_rng(9)
        for i in range(8):
            c = g.uniform(-1.0, 1.0, 3) * np.array([300.0, 80.0, 300.0])
            c[1] += 330.0
            b.add_sphere_light(tuple(c), 40.0, (5.0 + 3.0 * i, 20.0 - 2.0 * i, 8.0))
        out.append(b)
    return out


def _scenes(builders):
    jb, tb = builders
    jt, tt = jb.build(), tb.build(device="cpu")
    return (jt, jbuilder.scene_statics(jt)), (tt, tbuilder.scene_statics(tt))


@pytest.fixture(scope="module")
def cloud():
    return _scenes(_cloud_builders())


def _rays(n, seed=21):
    g = np.random.default_rng(seed)
    o = np.tile(np.float32([[0.0, 70.0, 550.0]]), (n, 1))
    o += g.normal(scale=30.0, size=(n, 3)).astype(np.float32)
    target = g.normal(scale=120.0, size=(n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _both(o, d, n):
    """(JAX rays, JAX keys), (port rays, port keys) of the same numbers."""
    return ((JRays(o=jnp.asarray(o), d=jnp.asarray(d)),
             j_path_keys(5, jnp.arange(n, dtype=jnp.int32), 0)),
            (Rays(o=torch.from_numpy(o), d=torch.from_numpy(d)),
             rng.path_keys(5, torch.arange(n), 0)))


def _camera():
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 70.0, 550.0, 1)
    return PinholeCamera.make(W / H, c2w=c2w, fov_deg=60.0, device="cpu")


def test_integrate_matches_jax_fused_kernel(cloud):
    """Plain K9a against the JAX Pallas kernel (interpret mode), NEE on."""
    (jt, jst), (tt, tst) = cloud
    o, d = _rays(N)
    (jrays, jkeys), (trays, tkeys) = _both(o, d, N)
    jf = jhk.try_make_fused_het_path_integrator(
        jt, jst, DEPTH, nee=True, max_steps=MAX_STEPS, interpret=True, force=True)
    tf = hk.try_make_fused_het_path_integrator(
        tt, tst, DEPTH, nee=True, max_steps=MAX_STEPS, force=True)
    assert jf is not None and tf is not None
    want = np.asarray(jf(jrays, jkeys))
    hk.reset_counts()
    got = tf(trays, tkeys).numpy()
    # CPU tensors: the plain version ran, no kernel was launched
    assert hk.counts()["het_path"] == {"launches": 0, "plain_calls": 1}
    assert got.shape == (N, 3) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **GATE)
    assert want.max() > 1.0 and (want.sum(axis=1) > 0).mean() > 0.05


@pytest.mark.parametrize("case", ["eight_lights_nee", "cloud_without_nee"])
def test_integrate_matches_jax_wavefront(cloud, case):
    """Plain K9a against the JAX wavefront integrator (``fused="off"``):
    with NEE on the 8-light cloud, and without NEE on the cloud."""
    if case == "cloud_without_nee":
        (jt, jst), (tt, tst) = cloud
        nee = False
    else:
        (jt, jst), (tt, tst) = _scenes(_eight_light_builders())
        nee = True
    o, d = _rays(N, seed=22)
    (jrays, jkeys), (trays, tkeys) = _both(o, d, N)
    # unroll=False: one traced iteration under a loop, where the unrolled
    # form traces and compiles every iteration's tracking loops anew (three
    # times the time); the same draws and arithmetic
    want = np.asarray(jvolume.make_volume_integrator(
        jt, jst, DEPTH, nee=nee, max_steps=MAX_STEPS, fused="off",
        unroll=False)(jrays, jkeys))
    tf = hk.try_make_fused_het_path_integrator(
        tt, tst, DEPTH, nee=nee, max_steps=MAX_STEPS, force=True)
    got = tf(trays, tkeys).numpy()
    np.testing.assert_allclose(got, want, **GATE)
    assert np.isfinite(got).all() and want.max() > 1.0
    if nee:
        assert want.mean() > 1e-3


def test_spp_renders_bitwise_and_resumed(cloud):
    """Plain K9b and K9c, raster and morton lane order: the same image bit
    for bit, the same reject counts; a chunk resumed at sample 2 continues
    the stream."""
    _, (tt, tst) = cloud
    cam = _camera()
    kw = dict(seed=2, max_depth=DEPTH, nee=True, max_steps=MAX_STEPS, force=True)
    out = {}
    hk.reset_counts()
    for persistent in (False, True):
        for order in ("raster", "morton"):
            rc = hk.try_make_fused_het_spp_render(
                tt, tst, cam, W, H, persistent=persistent, pixel_order=order, **kw)
            rad, rej = rc(0, 3)
            img = np.empty((W * H, 3), np.float32)
            img[rc.pixel_ids] = rad.numpy()
            out[persistent, order] = (img, int(rej))
    assert hk.counts()["het_spp"] == {"launches": 0, "plain_calls": 2}
    assert hk.counts()["het_spp_persistent"] == {"launches": 0, "plain_calls": 2}
    ref = out[True, "raster"]
    assert ref[0].sum() > 0.0
    for key, (img, rej) in out.items():
        np.testing.assert_array_equal(img, ref[0], err_msg=str(key))
        assert rej == ref[1]
    rc = hk.try_make_fused_het_spp_render(tt, tst, cam, W, H, **kw)
    first, rej_a = rc(0, 2)
    last, rej_b = rc(2, 1)
    np.testing.assert_array_equal((first + last).numpy(), out[True, "raster"][0])
    assert int(rej_a) + int(rej_b) == ref[1]


@pytest.mark.parametrize("preset", ["nee", "volume"])
def test_presets_are_eligible(preset):
    """The two cloud presets qualify, at their own depth, with the NEE
    flag of their integrator."""
    cfg = get_preset(preset)
    tables = getattr(tpresets, f"preset_{preset}")(device="cpu")[0]
    st = tbuilder.scene_statics(tables)
    assert hk._eligible_het(tables, st, cfg.max_depth) is not None
    hc = hk._het_consts(tables, st, cfg.max_depth, cfg.integrator == "vpt_nee",
                        None, None)
    ic = list(hc.ic)
    assert ic[:6] == [1, 1, cfg.max_depth, 2 * cfg.max_depth + 2,
                      int(cfg.integrator == "vpt_nee"), 0]
    assert hc.hm.max_steps == hc.max_steps and hc.hm.row == 0


@pytest.mark.parametrize("case", [
    "triangle", "two_media", "homogeneous_box", "non_emissive_sphere",
    "17_lights", "quad_light", "depth_0", "depth_129", "cpu_without_force",
])
def test_eligibility_refusals(case):
    """What ``_eligible_het`` refuses comes back as None, so that the
    wavefront route takes over; the gates of the JAX package's
    ``_eligible_het`` (without its VMEM bound)."""
    b = tpresets.build_volume_scene(res=(8, 8, 8))
    depth = 4
    force = True
    if case == "triangle":
        tri = np.asarray([[[2, 0, 0], [3, 0, 0], [2, 1, 0]]], np.float32)
        b.add_mesh(tri, material=b.add_lambert((0.5,) * 3))
    elif case == "two_media":
        b.add_homogeneous_medium(0.0, (0.5,) * 3, (0.5,) * 3, (400, 0, 0), (410, 10, 10))
    elif case == "homogeneous_box":
        b = tbuilder.SceneBuilder()
        b.add_homogeneous_medium(0.0, (0.5,) * 3, (0.5,) * 3, (-1, -1, -1), (1, 1, 1))
        b.add_sphere_light((0.0, 4.0, 0.0), 0.5, (5.0,) * 3)
    elif case == "non_emissive_sphere":
        b.add_sphere((0.0, 300.0, 0.0), 10.0, material=b.add_lambert((0.5,) * 3))
    elif case == "17_lights":
        for k in range(16):
            b.add_sphere_light((-400.0 + 50.0 * k, 300.0, 0.0), 5.0, (1.0,) * 3)
    elif case == "quad_light":
        b.add_quad_light((0, 300, 0), (10, 300, 0), (0, 300, 10), (1.0,) * 3)
    elif case == "depth_0":
        depth = 0
    elif case == "depth_129":
        depth = 129
    elif case == "cpu_without_force":
        force = False
    scene = b.build(device="cpu")
    st = tbuilder.scene_statics(scene)
    assert hk.try_make_fused_het_path_integrator(
        scene, st, depth, force=force) is None
    assert hk.try_make_fused_het_spp_render(
        scene, st, _camera(), W, H, 0, depth, force=force) is None
    if case == "17_lights":
        # one light fewer qualifies
        b2 = tpresets.build_volume_scene(res=(8, 8, 8))
        for k in range(15):
            b2.add_sphere_light((-400.0 + 50.0 * k, 300.0, 0.0), 5.0, (1.0,) * 3)
        s2 = b2.build(device="cpu")
        assert hk.try_make_fused_het_path_integrator(
            s2, tbuilder.scene_statics(s2), depth, force=True) is not None


def test_launch_constants_and_launchers():
    """``_het_consts``: the host arrays a launch carries, in the layout
    ``csrc/het_megakernel.cu::het_scene_from`` reads; the launchers the
    bindings declare exist in the source."""
    tables = tpresets.preset_nee(device="cpu")[0]
    hc = hk._het_consts(tables, tbuilder.scene_statics(tables), 32, True, None, None,
                        grad_sampling=True)
    fc, ic = np.asarray(list(hc.fc), np.float32), list(hc.ic)
    assert fc.size == 16 * 5 + 16 * 7 + 8
    assert ic == [1, 1, 32, 66, 1, 1, 8192, 8193, 8208]
    np.testing.assert_array_equal(fc[0:5], [0.0, 400.0, 0.0, 50.0, 0.0])  # sphere
    light = fc[16 * 5:16 * 5 + 7]
    np.testing.assert_array_equal(light, [0.0, 400.0, 0.0, 50.0, 30.0, 30.0, 30.0])
    box = fc[16 * 12:]
    np.testing.assert_array_equal(box[0:6], [-165, -110, -160, 165, 110, 160])
    assert box[6] == 0.0 and box[7] == np.float32(1.0)   # g, 1 / n_lights
    assert hc.hm.chan_uniform and list(hc.hm.ic)[6] == 1
    src = open(os.path.join(os.path.dirname(hk.__file__), "..", "csrc",
                            "het_megakernel.cu")).read()
    for name in hk.KERNEL_NAMES:
        assert f"int {name}(" in src
    assert set(hk._ARGTYPES) == set(hk.KERNEL_NAMES)


def _forced(monkeypatch):
    """Route ``make_volume_integrator``'s default to the heterogeneous
    kernel's entry point on CPU tables, as on the card."""
    orig = hk.try_make_fused_het_path_integrator
    monkeypatch.setattr(hk, "try_make_fused_het_path_integrator",
                        lambda *a, **k: orig(*a, force=True, **k))


def test_renderer_takes_the_het_route(cloud, monkeypatch):
    """An integrator that carries ``fused_spec`` with ``kind="het_volume"``
    is upgraded to one ``het_spp_persistent`` call per chunk; the image is
    the wavefront route's up to the camera ray's rounding (the kernels
    multiply by a float32 1 / width where the wavefront route divides)."""
    _, (tt, tst) = cloud
    cam = _camera()
    _forced(monkeypatch)
    fused = make_volume_integrator(tt, tst, DEPTH, nee=True, max_steps=MAX_STEPS)
    assert fused.fused_spec["kind"] == "het_volume"
    fused.fused_spec = dict(fused.fused_spec, force=True)
    wave = make_volume_integrator(tt, tst, DEPTH, nee=True, max_steps=MAX_STEPS,
                                  fused="never")
    assert not hasattr(wave, "fused_spec")
    hk.reset_counts()
    a = WavefrontRenderer(tt, cam, fused, W, H, seed=4).render(4, spp_chunk=2)
    assert hk.counts()["het_spp_persistent"]["plain_calls"] == 2
    assert hk.counts()["het_path"]["plain_calls"] == 0
    b = WavefrontRenderer(tt, cam, wave, W, H, seed=4).render(4)
    assert a.n_rejected == b.n_rejected == 0
    diff = np.abs(a.image - b.image)
    beyond = (diff > 2e-5 + 2e-4 * np.abs(b.image)).any(axis=-1)
    # a ray that differs in its last bit may take another decision somewhere
    # along a path: at most 2 of the 192 pixels
    assert int(beyond.sum()) <= 2, int(beyond.sum())
    assert abs(a.image.mean() - b.image.mean()) < 1e-3 * b.image.mean()
    # --stats keeps the wavefront loop
    assert not hasattr(make_volume_integrator(tt, tst, DEPTH, nee=True,
                                              with_stats=True), "fused_spec")


# the golden through the whole-render kernel's plain version: its camera ray
# multiplies by a float32 1 / width where the wavefront route that made the
# golden divides by the width, so a sample's ray may differ in its last bit
# and a pixel by a few ulps of its radiance. The gate is the one K1 and K6
# meet their goldens at (chip_smoke.py), ten times the golden's own
GOLDEN_GATE = dict(rtol=1e-4, atol=1e-5)


def test_cloud_golden_through_the_het_route(monkeypatch):
    """The heterogeneous NEE golden of tests/test_golden.py through the
    default route of the card, the whole-render kernel's plain version."""
    density = torch.from_numpy(tpresets.procedural_cloud(res=(24, 20, 16), seed=3)).to(
        torch.bfloat16).to(torch.float32).numpy()
    tables = tpresets.build_volume_scene(
        density=density, absorption=(0.02, 0.02, 0.02),
        scattering=(0.06, 0.05, 0.04), le=30.0).build("cpu")
    st = tbuilder.scene_statics(tables)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 70.0, 550.0, 1)
    cam = PinholeCamera.make(24 / 18, c2w=c2w, fov_deg=60.0, device="cpu")
    _forced(monkeypatch)
    integ = make_volume_integrator(tables, st, 8, nee=True, max_steps=96)
    integ.fused_spec = dict(integ.fused_spec, force=True)
    hk.reset_counts()
    r = render(tables, cam, integ, 24, 18, 4, seed=0)
    assert hk.counts()["het_spp_persistent"]["plain_calls"] == 1
    assert r.n_rejected == 0
    np.testing.assert_allclose(r.image, np.load(GOLDEN), **GOLDEN_GATE)


def test_grad_sampling_reaches_the_het_route(cloud, monkeypatch):
    """``grad_sampling`` (roulette off, uniform channel pick) on the default
    route equals the wavefront route's ``grad_sampling`` result, and differs
    from the default estimator."""
    _, (tt, tst) = cloud
    o, d = _rays(N // 4, seed=23)
    rays = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    keys = rng.path_keys(5, torch.arange(N // 4), 0)
    _forced(monkeypatch)
    kw = dict(nee=True, max_steps=MAX_STEPS)
    fused = make_volume_integrator(tt, tst, DEPTH, grad_sampling=True, **kw)
    assert fused.fused_spec["kind"] == "het_volume"
    assert fused.fused_spec["grad_sampling"] is True
    wave = make_volume_integrator(tt, tst, DEPTH, grad_sampling=True,
                                  fused="never", **kw)
    got = fused(rays, keys)
    np.testing.assert_array_equal(got.numpy(), wave(rays, keys).numpy())
    default = make_volume_integrator(tt, tst, DEPTH, **kw)(rays, keys)
    assert not torch.equal(got, default)
