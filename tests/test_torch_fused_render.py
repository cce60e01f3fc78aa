"""Port parity, the whole-render route: ``render_chunk(s0, n_spp)`` of the
port's ``integrators/megakernel.py`` against the JAX package's whole-render
kernels, and ``WavefrontRenderer`` on the fused route against the wavefront
route.

The JAX side runs its Pallas kernels in interpret mode (``interpret=True,
force=True``). The port runs on CPU tensors with ``force=True``, where each
wrapper takes its kernel's plain version (a host loop over the samples, the
kernels' camera-ray formulas, the wavefront bounce over the matmul-form
sweep). ``chip_smoke.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import os

import numpy as np
import pytest
import torch

from xraytracer_tpu.camera import PinholeCamera as JCamera
from xraytracer_tpu.integrators.megakernel import (
    try_make_fused_spp_render as j_try_spp,
)
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu_torch import cli
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.config import get_preset
from xraytracer_tpu_torch.integrators import make_path_integrator
from xraytracer_tpu_torch.integrators import megakernel as mk
from xraytracer_tpu_torch import renderer
from xraytracer_tpu_torch.renderer import (
    CAMERA_SITE,
    Accumulator,
    WavefrontRenderer,
    make_fused_chunk_fn,
    make_sample_fn,
    pixel_grid,
)
from xraytracer_tpu_torch.scene.builder import scene_statics
from xraytracer_tpu_torch.scene.presets import build_cornell_box, cornell_camera

torch.set_num_threads(1)

W, H = 64, 48
GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "cornell_gi_32x24_8spp_seed0.npy"
)

# Port's plain version vs the Pallas kernel in interpret mode: the same
# draws, the same camera-ray formulas (constants rounded on the host,
# multiplication by 1 / width) and the same decisions, so sums of a few
# samples agree to float32 rounding of the hit test and of sin / cos.
# Measured: at depth 3 with cosine sampling 2 of 9,216 values differ by
# 4.8e-5 relative (a near-grazing second bounce amplifies the rounding of
# the first hit point), every other value by less than 2e-5. The JAX
# package holds its kernel to its own renderer at rtol 2e-3 / atol 2e-3.
GATE = dict(rtol=1e-4, atol=1e-5)

# Fused route vs wavefront route inside the port. The wavefront route
# divides the jittered pixel coordinate by the width where the kernels
# multiply by a rounded 1 / width, so camera rays differ in the last bit
# and with them every value by a few ulp: the golden's own gate (rtol 1e-5
# / atol 1e-6) is then too tight for a few values, and rtol 2e-4 / atol
# 2e-5 holds for every value unless a ray grazing an edge flips a hit,
# which at most ``FLIPS`` pixels may do.
ROUTE_GATE = dict(rtol=2e-4, atol=2e-5)
FLIPS = 2


@pytest.fixture(scope="module")
def cornell():
    tables = build_cornell_box().build(device="cpu")
    return tables, scene_statics(tables)


@pytest.fixture(scope="module")
def jax_cornell():
    jt = jpresets.build_cornell_box().build()
    return jt, jbuilder.scene_statics(jt)


def _cam(w=W, h=H):
    return PinholeCamera.make(w / h, device="cpu", **cornell_camera())


def _jcam(w=W, h=H):
    return JCamera.make(w / h, **jpresets.cornell_camera())


def _forced(integrate, tables, st, max_depth, **opts):
    """Give a wavefront integrator the ``fused_spec`` it would carry on the
    card, with ``force=True`` so that CPU tables qualify."""
    integrate.fused_spec = dict(
        scene=tables, statics=st, max_depth=max_depth, force=True,
        **{"nee": True, "le_depth0_only": True, "cosine_sampling": False,
           "nee_mode": "all", "pick_weights": None, **opts},
    )
    return integrate


def test_render_chunk_matches_jax_with_a_resumed_chunk(cornell, jax_cornell):
    tables, st = cornell
    jt, jst = jax_cornell
    kw = dict(seed=3, max_depth=2, nee=True, force=True)
    jf = j_try_spp(jt, jst, _jcam(), W, H, interpret=True, **kw)
    tf = mk.try_make_fused_spp_render(tables, st, _cam(), W, H, **kw)
    assert jf is not None and tf is not None
    n = W * H
    assert tf.n_pad == n and tf.pixel_order == "raster"
    np.testing.assert_array_equal(tf.pixel_ids, np.arange(n))
    mk.reset_counts()
    total = np.zeros((n, 3), np.float32)
    for s0, n_spp in ((0, 2), (2, 1)):  # the second chunk continues the stream
        rad, rej = tf(s0, n_spp)
        jrad, jrej = jf(s0, n_spp)
        assert rad.shape == (n, 3) and rad.dtype == torch.float32
        np.testing.assert_allclose(rad.numpy(), np.asarray(jrad)[:n], **GATE)
        assert int(rej) == int(jrej) == 0
        total += rad.numpy()
    assert mk.counts()["mega_spp_persistent"] == {"launches": 0, "plain_calls": 2}
    # two chunks are one run of three samples
    straight, rej = tf(0, 3)
    np.testing.assert_allclose(straight.numpy(), total, rtol=1e-6, atol=1e-7)
    assert total.mean() / 3.0 > 1e-3


@pytest.mark.parametrize("persistent", [False, True])
def test_per_sample_and_merged_loop_match_jax(cornell, jax_cornell, persistent):
    """``persistent=False`` (``mega_spp``) and ``persistent=True``
    (``mega_spp_persistent``) compute one function; each against its own
    JAX kernel, depth 3 with cosine sampling."""
    tables, st = cornell
    jt, jst = jax_cornell
    kw = dict(seed=3, max_depth=3, nee=True, cosine_sampling=True, force=True,
              persistent=persistent)
    jf = j_try_spp(jt, jst, _jcam(), W, H, interpret=True, **kw)
    tf = mk.try_make_fused_spp_render(tables, st, _cam(), W, H, **kw)
    mk.reset_counts()
    rad, rej = tf(0, 3)
    name = "mega_spp_persistent" if persistent else "mega_spp"
    assert mk.PLAIN_CALLS[name] == 1 and sum(mk.PLAIN_CALLS.values()) == 1
    jrad, jrej = jf(0, 3)
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad)[:W * H], **GATE)
    assert int(rej) == int(jrej)
    assert float(rad.abs().sum()) > 0.0


def test_raster_and_morton_bitwise(cornell, jax_cornell):
    """A pixel's stream depends only on its id, so the lane order changes no
    bit of the image; the morton lane map is the JAX package's."""
    tables, st = cornell
    jt, jst = jax_cornell
    kw = dict(seed=3, max_depth=2, nee=True, force=True)
    raster = mk.try_make_fused_spp_render(tables, st, _cam(), W, H, **kw)
    morton = mk.try_make_fused_spp_render(tables, st, _cam(), W, H,
                                          pixel_order="morton", **kw)
    rad_r, rej_r = raster(0, 2)
    rad_m, rej_m = morton(0, 2)
    out = np.empty((W * H, 3), np.float32)
    out[morton.pixel_ids] = rad_m.numpy()
    np.testing.assert_array_equal(out, rad_r.numpy())
    assert int(rej_r) == int(rej_m)
    assert morton.pixel_order == "morton"
    jm = j_try_spp(jt, jst, _jcam(), W, H, pixel_order="morton",
                   interpret=True, **kw)
    np.testing.assert_array_equal(morton.pixel_ids,
                                  np.asarray(jm.pixel_ids)[:W * H])


def test_rejected_samples_are_counted_and_left_out(cornell):
    """A NaN, an Inf and a negative sample are dropped and counted, per
    lane, by the plain spp loop as by the kernels."""
    tables, st = cornell

    def bad(view, s0, n_spp):
        fs = mk._bake(tables, st, 2, True, True, False)
        fs._plain = {False: lambda rays, keys: torch.tensor(
            [[float("nan"), 1, 1], [1, float("inf"), 1], [1, 1, -1.0]]
            + [[1.0, 1.0, 1.0]] * (view.n - 3))}
        return mk.mega_spp_plain(fs, view, s0, n_spp)

    chunk = mk.make_spp_render(bad, _cam(8, 6), 8, 6, 0)
    rad, rej = chunk(0, 2)
    assert int(rej) == 6
    np.testing.assert_array_equal(rad[:3].numpy(), 0.0)
    np.testing.assert_array_equal(rad[3:].numpy(), 2.0)
    assert chunk.view.n == chunk.n_pad == 48


def test_camera_rays_of_the_kernels_are_the_renderers(cornell):
    """Keys are bitwise the renderer's; directions differ only by the
    rounding of 1 / width against a division."""
    tables, st = cornell
    cam = _cam()
    chunk = mk.try_make_fused_spp_render(tables, st, cam, W, H, seed=5,
                                         max_depth=2, force=True)
    seen = {}

    def spy(rays, keys):
        seen["rays"], seen["keys"] = rays, keys
        return torch.zeros((keys.shape[0], 3))

    ids, xy = pixel_grid(W, H, device="cpu")
    for s in (0, 7):
        make_sample_fn(tables, cam, spy, W, H, 5)(ids, xy, s)
        keys, o, d = mk._camera_rays_plain(chunk.view, s)
        np.testing.assert_array_equal(keys.numpy(), seen["keys"].numpy())
        np.testing.assert_array_equal(o.numpy(), seen["rays"].o.numpy())
        np.testing.assert_allclose(d.numpy(), seen["rays"].d.numpy(),
                                   rtol=0, atol=5e-7)
    # the constants, rounded as the kernels take them
    view = chunk.view
    assert view.cam.dtype == np.float32 and view.cam.shape == (16,)
    scale, aspect = float(cam.scale), float(cam.aspect)
    np.testing.assert_array_equal(
        view.cam[12:],
        np.asarray([scale, scale / aspect, 1.0 / W, 1.0 / H]).astype(np.float32))
    assert view.cam_site == (CAMERA_SITE * 0x9E3779B9) % 2 ** 32


def test_a_camera_that_is_no_pinhole_is_refused(cornell):
    tables, st = cornell
    assert mk.try_make_fused_spp_render(
        tables, st, object(), W, H, seed=0, max_depth=2, force=True) is None
    assert mk.try_make_fused_spp_render(
        tables, st, _cam(), W, H, seed=0, max_depth=2) is None  # CPU, no force


@pytest.mark.parametrize("order", ["raster", "morton"])
def test_renderer_fused_route_equals_wavefront_route(cornell, order):
    w, h, spp = 32, 24, 4
    tables, st = cornell
    wave = make_path_integrator(tables, st, 3, nee=True, fused="never")
    ref = WavefrontRenderer(tables, _cam(w, h), wave, w, h, seed=0,
                            pixel_order=order).render(spp)
    forced = _forced(make_path_integrator(tables, st, 3, nee=True), tables, st, 3)
    r = WavefrontRenderer(tables, _cam(w, h), forced, w, h, seed=0,
                          pixel_order=order)
    mk.reset_counts()
    out = r.render(spp, spp_chunk=3)
    # one call of the whole-render entry point per chunk, nothing else
    assert mk.PLAIN_CALLS == {"mega_path": 0, "mega_spp": 0,
                              "mega_spp_persistent": 2, "mega_grad_path": 0}
    assert out.n_rejected == ref.n_rejected == 0 and out.spp == spp
    close = np.isclose(out.image, ref.image, **ROUTE_GATE).all(axis=-1)
    assert (~close).sum() <= FLIPS, (~close).sum()
    assert abs(out.image.mean() - ref.image.mean()) <= 1e-3 * ref.image.mean()


def test_renderer_fused_route_reproduces_the_golden(cornell):
    tables, st = cornell
    forced = _forced(make_path_integrator(tables, st, 3, nee=True), tables, st, 3)
    out = WavefrontRenderer(tables, _cam(32, 24), forced, 32, 24, seed=0).render(8)
    golden = np.load(GOLDEN)
    close = np.isclose(out.image, golden, **ROUTE_GATE).all(axis=-1)
    assert (~close).sum() <= FLIPS, (~close).sum()
    assert out.n_rejected == 0


def test_renderer_fused_route_resumes_from_a_checkpoint(cornell, tmp_path):
    w, h, spp = 16, 12, 7
    tables, st = cornell

    def renderer():
        forced = _forced(make_path_integrator(tables, st, 3, nee=True),
                         tables, st, 3)
        return WavefrontRenderer(tables, _cam(w, h), forced, w, h, seed=1)

    # a chunk's samples are summed before they join the accumulator, so
    # the chunking is part of the rounding: compare at the same chunking
    straight = renderer().render(spp, spp_chunk=3)
    ck = str(tmp_path / "acc.npz")
    part = renderer().render(3, spp_chunk=3, checkpoint_path=ck)
    assert part.spp == 3
    acc = Accumulator.load(ck, device="cpu")
    assert acc.spp_done == 3
    resumed = renderer().render(spp, spp_chunk=3, accumulator=acc,
                                checkpoint_path=ck)
    np.testing.assert_array_equal(resumed.image, straight.image)
    assert resumed.n_rejected == straight.n_rejected == 0
    assert Accumulator.load(ck, device="cpu").spp_done == spp
    one_chunk = renderer().render(spp, spp_chunk=spp)
    np.testing.assert_allclose(one_chunk.image, straight.image, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("spp", [1, 3, 7])
@pytest.mark.parametrize("order", ["raster", "morton"])
@pytest.mark.parametrize("route", ["fused", "wavefront"])
def test_image_is_the_host_assembly_of_its_sums(cornell, route, order, spp):
    """The renderer assembles on the sums' device: the image is bitwise the
    host assembly the renderer made before (a numpy scatter by the lane map,
    then ``/ spp``) of the same sums, and a render without a checkpoint
    copies one frame-sized array, the image, between host and device."""
    w, h = 16, 12
    tables, st = cornell
    if route == "fused":
        integ = _forced(make_path_integrator(tables, st, 2, nee=True), tables, st, 2)
    else:
        integ = make_path_integrator(tables, st, 2, nee=True, fused="never")
    r = WavefrontRenderer(tables, _cam(w, h), integ, w, h, seed=6, pixel_order=order)
    acc = Accumulator(w, h, device="cpu")
    renderer.reset_counts()
    out = r.render(spp, spp_chunk=2, accumulator=acc)
    assert renderer.counts() == {"frame_copies": 1}
    from test_torch_slice import _numpy_lanes

    img = np.empty((w * h, 3), np.float32)
    img[_numpy_lanes(w, h, order)] = acc.acc.numpy()
    np.testing.assert_array_equal(out.image, img.reshape(h, w, 3) / spp)
    assert out.image.dtype == np.float32 and out.image.flags.owndata
    assert out.image.mean() > 1e-3
    np.testing.assert_array_equal(acc.image(), out.image)


def test_fused_chunk_runner_updates_in_place():
    calls = []

    def fused_render(s0, n):
        calls.append((s0, n))
        return torch.full((4, 3), float(n)), torch.tensor(1)

    acc = torch.ones((4, 3))
    nrej = torch.zeros((), dtype=torch.int64)
    out, nr, stats = make_fused_chunk_fn(fused_render)(acc, nrej, None, None, 5, 2)
    assert out is acc and nr is nrej and stats is None
    assert calls == [(5, 2)] and int(nrej) == 1
    np.testing.assert_array_equal(acc.numpy(), 3.0)


@pytest.mark.parametrize("opts", [
    dict(tri_fn="any"), dict(with_stats=True), dict(mis=True),
    dict(fused="never"), dict(fused="off"), dict(fused=False),
], ids=["tri_fn", "with_stats", "mis", "never", "off", "False"])
def test_options_that_keep_the_wavefront_route(cornell, monkeypatch, opts):
    """``fused="auto"`` asks the fused factory only without ``tri_fn``,
    ``with_stats`` and ``mis``; any other ``fused`` value never asks."""
    tables, st = cornell
    asked = []
    monkeypatch.setattr(
        mk, "try_make_fused_path_integrator",
        lambda *a, **k: asked.append(k) or None)
    if opts.get("tri_fn"):
        from xraytracer_tpu_torch.geometry.intersect import intersect_triangles_mm
        opts = dict(tri_fn=intersect_triangles_mm)
    make_path_integrator(tables, st, 3, **opts)
    assert asked == []
    make_path_integrator(tables, st, 3, nee=True, nee_mode="power")
    assert len(asked) == 1 and asked[0]["nee_mode"] == "power"
    assert asked[0]["le_depth0_only"] is True


def test_auto_route_carries_the_spec_the_renderer_needs(cornell, monkeypatch):
    """On an eligible scene ``fused="auto"`` returns the fused integrator
    with ``fused_spec``; the CLI's GI preset goes the same way."""
    tables, st = cornell
    real = mk.try_make_fused_path_integrator
    monkeypatch.setattr(mk, "try_make_fused_path_integrator",
                        lambda *a, **k: real(*a, force=True, **k))
    cfg = get_preset("cornellbox_gi", width=16, height=12, spp=1)
    integ = cli.make_integrator(cfg, tables, st)
    assert set(integ.fused_spec) == {
        "scene", "statics", "max_depth", "nee", "le_depth0_only",
        "cosine_sampling", "nee_mode", "pick_weights"}
    assert integ.fused_spec["max_depth"] == cfg.max_depth
    assert integ.fused_spec["nee"] is True
    # with --stats the CLI keeps the wavefront route and its counters
    assert not hasattr(cli.make_integrator(cfg, tables, st, with_stats=True),
                       "fused_spec")
