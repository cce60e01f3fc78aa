"""Port parity, surface gradients: the port's ``diff.py`` (autograd through
the wavefront integrator), its analytic-gradient kernel's plain version
(``megakernel.mega_grad_path_plain``) and ``tools/fit_scene.py`` against
the JAX package's ``diff.py``, ``try_make_fused_grad_path`` and
``tools/fit_scene.py`` on the same scenes, pixels and path keys.

The JAX side runs its Pallas kernel K5 in interpret mode (``interpret=True,
force=True``, as ``tests/test_diff.py`` does), once, in a module-scoped
fixture; its autodiff gradients come from ``jax.value_and_grad`` of its
wavefront pipeline over the matmul sweep. The port runs on CPU tensors,
where every kernel wrapper takes its plain version. The CUDA kernel K5 is
held against the same plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xraytracer_tpu.camera import PinholeCamera as JCamera
from xraytracer_tpu.diff import make_loss_fn as j_make_loss_fn
from xraytracer_tpu.diff import make_radiance_fn as j_make_radiance_fn
from xraytracer_tpu.integrators.megakernel import (
    try_make_fused_grad_path as j_try_fused_grad,
)
from xraytracer_tpu.math import from_rows as j_from_rows
from xraytracer_tpu.renderer import CAMERA_SITE as J_CAMERA_SITE
from xraytracer_tpu.renderer import pixel_grid as j_pixel_grid
from xraytracer_tpu.sampling import path_keys as j_path_keys
from xraytracer_tpu.sampling import uniform2 as j_uniform2
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu.scene.tables import rejoin_appearance as j_rejoin
from xraytracer_tpu_torch import convert, diff
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.config import get_preset
from xraytracer_tpu_torch.geometry import Rays, kernels
from xraytracer_tpu_torch.geometry.intersect import (
    intersect_triangles_mm,
    occluded,
    tables_present,
)
from xraytracer_tpu_torch.integrators import megakernel as mk
from xraytracer_tpu_torch.renderer import pixel_grid
from xraytracer_tpu_torch.sampling import path_keys
from xraytracer_tpu_torch.scene import builder as tbuilder
from xraytracer_tpu_torch.scene import presets as tpresets
from xraytracer_tpu_torch.scene.tables import rejoin_appearance

torch.set_num_threads(1)

# the Cornell case of tests/test_diff.py::test_analytic_grad_kernel_matches_autodiff:
# 32x24, depth 3, cosine sampling, sample 1, zero target, Le x 1.3
W, H, DEPTH, SAMPLE, LE_SCALE = 32, 24, 3, 1, 1.3
# per-lane gate, port plain K5 vs JAX K5: both follow the same draws and
# decisions, so lanes agree to float32 rounding (measured <= 4e-6 on values
# of up to 33); a lane whose roulette or hit flipped between the two sweeps'
# roundings would move as a whole, and at most this many may
LANE_RTOL, LANE_ATOL, LANE_COUNT_GATE = 1e-4, 1e-5, 2
# contracted gradients: tests/test_diff.py's own tolerances
GRAD_RTOL, GRAD_ATOL_REL = 2e-3, 2e-4
LOSS_RTOL = 2e-4


def _j_cornell():
    jt = jpresets.build_cornell_box().build()
    return jt, jbuilder.scene_statics(jt)


def _t_cornell():
    tt = tpresets.build_cornell_box().build(device="cpu")
    return tt, tbuilder.scene_statics(tt)


def _t_setup(w, h, max_depth, cosine=True, tables=None, **kw):
    tt, st = _t_cornell() if tables is None else (tables, tbuilder.scene_statics(tables))
    cam = PinholeCamera.make(w / h, device="cpu", **tpresets.cornell_camera())
    radiance = diff.make_radiance_fn(tt, st, cam, w, h, max_depth=max_depth,
                                     cosine_sampling=cosine, seed=0, **kw)
    ids, xy = pixel_grid(w, h, device="cpu")
    return tt, st, cam, radiance, ids, xy


def _contract(img, galb, gle, target):
    n = img.shape[0]
    r = 2.0 * (img - target) / (n * 3)
    return (np.einsum("nc,nckm->mk", r, galb), np.einsum("nc,ncl->lc", r, gle))


def _assert_grad_close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=GRAD_ATOL_REL * max(1e-6, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def cornell_case():
    """Everything the Cornell comparisons share, computed once: JAX's
    autodiff loss and gradients, JAX's K5 in interpret mode, and the port's
    plain K5 on JAX's camera rays and the port's own path keys."""
    jt, jst = _j_cornell()
    jcam = JCamera.make(W / H, **jpresets.cornell_camera())
    ids, xy = j_pixel_grid(W, H)
    n = W * H
    target = jnp.zeros((n, 3))
    params = {"mat_albedo": jt.mat_albedo, "al_le": jt.al_le * LE_SCALE}
    j_loss = j_make_loss_fn(j_make_radiance_fn(
        jt, jst, jcam, W, H, max_depth=DEPTH, cosine_sampling=True,
        geometry_grads=True))
    val, g = jax.jit(jax.value_and_grad(j_loss))(params, ids, xy, target, SAMPLE)

    jf = j_try_fused_grad(jt, jst, max_depth=DEPTH, nee=True,
                          cosine_sampling=True, interpret=True, force=True)
    keys = j_path_keys(0, ids, SAMPLE)
    u = j_uniform2(keys, J_CAMERA_SITE)
    rays = jcam.sample_rays((xy + u) / jnp.asarray([float(W), float(H)]))
    scene_p = j_rejoin(jt._replace(**params))
    j_out = jf(rays, keys, tri_rec=scene_p.tri_rec, al_le=params["al_le"])

    tt, tst = _t_cornell()
    tf = mk.try_make_fused_grad_path(tt, tst, DEPTH, nee=True,
                                     cosine_sampling=True, force=True)
    t_le = tt.al_le * LE_SCALE
    t_rec = rejoin_appearance(tt._replace(al_le=t_le)).tri_rec
    o = torch.from_numpy(np.array(rays.o))
    d = torch.from_numpy(np.array(rays.d))
    mk.reset_counts()
    t_out = tf(Rays(o=o, d=d), path_keys(0, torch.arange(n), SAMPLE),
               tri_rec=t_rec, al_le=t_le)
    counts = mk.counts()["mega_grad_path"]
    return dict(
        j_val=float(val), j_grads={k: np.asarray(v) for k, v in g.items()},
        j_out=[np.asarray(x) for x in j_out],
        t_out=[x.numpy() for x in t_out], t_counts=counts,
        n_mats=tf.n_mats, n_lights=tf.n_lights,
    )


def test_tie_gradient_matches_jax_value_and_grad(cornell_case):
    """The port's autograd gradient equals jax.value_and_grad's, the white
    row included: Cornell white is exactly (1, 1, 1), so every lane that
    bounces off a white wall reaches the roulette with mean throughput 1,
    where minimum / maximum have derivative 1/2 (clamp's is 1, 26% off on
    the white row)."""
    tt, st, cam, radiance, ids, xy = _t_setup(W, H, DEPTH)
    loss = diff.make_loss_fn(radiance)
    params = {"mat_albedo": tt.mat_albedo, "al_le": tt.al_le * LE_SCALE}
    val, g = diff.value_and_grad(loss)(params, ids, xy, torch.zeros((W * H, 3)),
                                       SAMPLE)
    want = cornell_case["j_grads"]
    np.testing.assert_allclose(float(val), cornell_case["j_val"], rtol=1e-5)
    white = int(np.argmax(np.asarray(tt.mat_albedo).sum(axis=1)))
    assert np.all(np.asarray(tt.mat_albedo[white]) == 1.0)
    np.testing.assert_allclose(g["mat_albedo"][white].numpy(),
                               want["mat_albedo"][white], rtol=1e-4)
    np.testing.assert_allclose(g["mat_albedo"].numpy(), want["mat_albedo"],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(g["al_le"].numpy(), want["al_le"],
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("what", ["img", "galb", "gle"])
def test_plain_grad_kernel_matches_jax_kernel_per_lane(cornell_case, what):
    """The plain version of K5 (forward-mode autodiff of the port's
    wavefront integrator, direction by direction) against JAX's K5 in
    interpret mode, lane by lane."""
    k = ("img", "galb", "gle").index(what)
    got, want = cornell_case["t_out"][k], cornell_case["j_out"][k]
    assert cornell_case["t_counts"] == {"launches": 0, "plain_calls": 1}
    n = W * H
    m, l = cornell_case["n_mats"], cornell_case["n_lights"]
    shape = {"img": (n, 3), "galb": (n, 3, 3, m), "gle": (n, 3, l)}[what]
    assert got.shape == want.shape == shape and (m, l) == (3, 1)
    assert np.isfinite(got).all()
    beyond = (np.abs(got - want) > LANE_ATOL + LANE_RTOL * np.abs(want))
    assert int(beyond.reshape(n, -1).any(axis=1).sum()) <= LANE_COUNT_GATE
    assert np.abs(want).max() > 0.0


def test_plain_grad_kernel_contracted_matches_jax(cornell_case):
    """Contracted through the L2 loss, the plain K5 gives JAX K5's and
    JAX autodiff's gradients (tests/test_diff.py's tolerances)."""
    n = W * H
    target = np.zeros((n, 3), np.float32)
    t_alb, t_le = _contract(*cornell_case["t_out"], target)
    j_alb, j_le = _contract(*cornell_case["j_out"], target)
    _assert_grad_close(t_alb, j_alb)
    _assert_grad_close(t_le, j_le)
    ref = cornell_case["j_grads"]
    _assert_grad_close(t_alb, ref["mat_albedo"])
    _assert_grad_close(t_le, ref["al_le"][: t_le.shape[0]])
    val = float(np.mean(cornell_case["t_out"][0] ** 2))
    np.testing.assert_allclose(val, cornell_case["j_val"], rtol=LOSS_RTOL)


def test_albedo_grad_matches_finite_difference():
    """d loss / d albedo: reverse mode == central differences at matched
    random numbers (tests/test_diff.py's probes and tolerance)."""
    tt, _, _, radiance, ids, xy = _t_setup(16, 12, 2)
    loss = diff.make_loss_fn(radiance)
    target = torch.zeros((16 * 12, 3))

    def f(albedo):
        return loss({"mat_albedo": albedo}, ids, xy, target, 0)

    a0 = tt.mat_albedo
    _, g = diff.value_and_grad(lambda p: f(p["mat_albedo"]))({"mat_albedo": a0})
    g = g["mat_albedo"]
    assert float(g.abs().sum()) > 0.0
    eps = 1e-3
    with torch.no_grad():
        for (i, c) in [(0, 0), (1, 1)]:
            da = torch.zeros_like(a0)
            da[i, c] = eps
            fd = (float(f(a0 + da)) - float(f(a0 - da))) / (2 * eps)
            ad = float(g[i, c])
            assert abs(fd - ad) < 5e-3 * max(1.0, abs(fd)), (i, c, fd, ad)


def test_le_grad_nonzero_and_matches_fd():
    tt, _, _, radiance, ids, xy = _t_setup(16, 12, 2)
    loss = diff.make_loss_fn(radiance)
    target = torch.zeros((16 * 12, 3))

    def f(le):
        return loss({"al_le": le}, ids, xy, target, 0)

    le0 = tt.al_le
    _, g = diff.value_and_grad(lambda p: f(p["al_le"]))({"al_le": le0})
    g = g["al_le"]
    assert float(g.abs().sum()) > 0.0
    eps = 1e-2
    da = torch.zeros_like(le0)
    da[0, 0] = eps
    with torch.no_grad():
        fd = (float(f(le0 + da)) - float(f(le0 - da))) / (2 * eps)
    assert abs(fd - float(g[0, 0])) < 5e-3 * max(1.0, abs(fd))


def test_inverse_rendering_step_descends():
    """One SGD step on the albedo reduces the loss against a darker
    target."""
    tt, _, _, radiance, ids, xy = _t_setup(16, 12, 2)
    with torch.no_grad():
        target = 0.5 * radiance({"mat_albedo": tt.mat_albedo}, ids, xy, 0)
    step = diff.make_train_step(radiance, lr=0.1)
    params = {"mat_albedo": tt.mat_albedo}
    l0, params, g = step(params, ids, xy, target, 0)
    l1, _, _ = step(params, ids, xy, target, 0)
    assert np.isfinite(float(l0)) and np.isfinite(float(l1))
    assert float(l1) < float(l0)
    assert torch.isfinite(g["mat_albedo"]).all()


def test_inverse_rendering_recovers_albedo_and_le():
    """tools/fit_scene.py end to end at tests/test_diff.py's size and
    thresholds: from mid-gray materials and a dim lamp, stochastic descent
    on the L2 image loss recovers the wall albedos and brightens the lamp
    toward its true emission (autograd route: CPU tables)."""
    from xraytracer_tpu_torch.tools.fit_scene import fit

    stats = {}
    hist, fitted, true = fit(width=24, height=18, steps=150, verbose=False,
                             device="cpu", stats=stats)
    assert stats["route"] == "autograd" and stats["grads_finite"]
    assert stats["n_rejected"] == 0
    init_alb_mae = float(np.abs(0.5 - true["mat_albedo"]).mean())
    fit_alb_mae = float(np.abs(fitted["mat_albedo"] - true["mat_albedo"]).mean())
    assert fit_alb_mae < 0.6 * init_alb_mae, (init_alb_mae, fit_alb_mae)
    assert float(fitted["al_le"].mean()) > 12.0, fitted["al_le"]
    k = max(len(hist) // 5, 1)
    assert np.mean(hist[-k:]) < np.mean(hist[:k])


def _light_box(mod, device=None):
    """The 16-light power-NEE box of tests/test_diff.py (geometric normals
    toward the room, 4 x 4 ceiling quads of skewed powers)."""
    b = mod.SceneBuilder()
    white = b.add_lambert((0.7, 0.7, 0.7))
    quads = []
    for v0, v1, v2, v3 in (
        ((0, 0, 0), (556, 0, 0), (556, 0, 559), (0, 0, 559)),
        ((0, 0, 559), (556, 0, 559), (556, 548, 559), (0, 548, 559)),
        ((0, 548, 0), (556, 548, 0), (556, 548, 559), (0, 548, 559)),
    ):
        quads.append(np.asarray([[v0, v2, v1], [v0, v3, v2]], np.float32))
    b.add_mesh(np.concatenate(quads, axis=0), material=white)
    g = np.random.default_rng(3)
    for i in range(4):
        for j in range(4):
            x0 = 60.0 + i * 110.0
            z0 = 60.0 + j * 110.0
            le = float(g.uniform(1.0, 30.0))
            b.add_quad_light(
                (x0, 547.0, z0), (x0 + 40.0, 547.0, z0),
                (x0, 547.0, z0 + 40.0), (le, 0.8 * le, 0.6 * le),
            )
    return b.build() if device is None else b.build(device)


_BOX_C2W = (-1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, -1.0, 0, 278.0, 273.0, -600.0, 1)


def test_power_nee_16_lights_plain_grad_kernel_matches_jax_autodiff():
    """K5's plain version with a power-picked light per vertex on the
    16-light box (M = 1, L = 16) against jax.value_and_grad of the JAX
    wavefront power-NEE pipeline: the pick weights bake from the base
    tables on both sides, dE goes to the picked light only."""
    w, h = 24, 18
    n = w * h
    jt = _light_box(jbuilder)
    jst = jbuilder.scene_statics(jt)
    assert jst["n_area_lights"] == 16
    jcam = JCamera.make(w / h, c2w=j_from_rows(*_BOX_C2W), fov_deg=38.0)
    ids, xy = j_pixel_grid(w, h)
    params = {"mat_albedo": jt.mat_albedo, "al_le": jt.al_le}
    j_loss = j_make_loss_fn(j_make_radiance_fn(
        jt, jst, jcam, w, h, max_depth=2, cosine_sampling=True,
        geometry_grads=True, nee_mode="power"))
    val, g = jax.jit(jax.value_and_grad(j_loss))(params, ids, xy,
                                                 jnp.zeros((n, 3)), 1)
    keys = j_path_keys(0, ids, 1)
    u = j_uniform2(keys, J_CAMERA_SITE)
    rays = jcam.sample_rays((xy + u) / jnp.asarray([w, h], jnp.float32))

    tt = _light_box(tbuilder, device="cpu")
    tst = tbuilder.scene_statics(tt)
    tf = mk.try_make_fused_grad_path(tt, tst, 2, nee=True, cosine_sampling=True,
                                     force=True, nee_mode="power")
    assert (tf.n_mats, tf.n_lights) == (1, 16)
    img, galb, gle = tf(Rays(o=torch.from_numpy(np.array(rays.o)),
                             d=torch.from_numpy(np.array(rays.d))),
                        path_keys(0, torch.arange(n), 1))
    img, galb, gle = img.numpy(), galb.numpy(), gle.numpy()
    np.testing.assert_allclose(float(np.mean(img ** 2)), float(val), rtol=3e-4)
    g_alb, g_le = _contract(img, galb, gle, np.zeros((n, 3), np.float32))
    np.testing.assert_allclose(g_alb, np.asarray(g["mat_albedo"]), rtol=5e-3,
                               atol=1e-7)
    np.testing.assert_allclose(g_le, np.asarray(g["al_le"])[:16], rtol=5e-3,
                               atol=1e-7)
    assert np.abs(g_le).max() > 0


def test_fast_value_and_grad_matches_autograd_with_live_params():
    """``try_make_fast_value_and_grad`` (forced onto the CPU, so K5's plain
    version) against autograd of the same loss, at overridden albedo and
    emission: both parameters are live, nothing was baked from them."""
    w, h = 16, 12
    tt, st, cam, radiance, ids, xy = _t_setup(w, h, 2)
    params = {"mat_albedo": tt.mat_albedo * torch.tensor([0.9, 0.8, 0.7]),
              "al_le": tt.al_le * LE_SCALE}
    with torch.no_grad():
        target = 0.5 * radiance(params, ids, xy, 3)
    fast = diff.try_make_fast_value_and_grad(tt, st, cam, w, h, max_depth=2,
                                             force=True)
    assert fast is not None
    aux = {}
    val_f, g_f = fast(params, ids, xy, target, 0, aux=aux)
    val, g = diff.value_and_grad(diff.make_loss_fn(radiance))(
        params, ids, xy, target, 0)
    assert aux["img"].shape == (w * h, 3)
    np.testing.assert_allclose(float(val_f), float(val), rtol=LOSS_RTOL)
    for k in ("mat_albedo", "al_le"):
        _assert_grad_close(g_f[k].numpy(), g[k].numpy())
    only_alb = fast({"mat_albedo": params["mat_albedo"]}, ids, xy, target, 0)[1]
    assert set(only_alb) == {"mat_albedo"}


def test_stopgrad_sweep_forward_equals_mm_with_zero_gradients_and_tangents():
    tt, _ = _t_cornell()
    g = np.random.default_rng(5)
    n = 200
    o = torch.from_numpy(np.tile(np.float32([278.0, 273.0, -600.0]), (n, 1)))
    dn = g.normal(size=(n, 3)).astype(np.float32) * 0.3 + np.float32([0, 0, 1])
    d = torch.from_numpy(dn / np.linalg.norm(dn, axis=1, keepdims=True))
    valid = tt.tri_obj >= 0
    args = (tt.tri_v0, tt.tri_e1, tt.tri_e2, valid)
    assert kernels.sweep_nearest_stopgrad_tri_fn.detached_ok is True
    ref = intersect_triangles_mm(Rays(o=o, d=d), *args)
    kernels.reset_counts()
    og, dg = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
    out = kernels.sweep_nearest_stopgrad_tri_fn(Rays(o=og, d=dg), *args)
    assert kernels.counts()["sweep_nearest"] == {"launches": 0, "plain_calls": 1}
    for a, b in zip(out, ref):
        assert torch.equal(a.detach(), b)
    assert out[1].dtype == torch.int32 and (out[1] >= 0).sum() > n // 2
    ga, gb = torch.autograd.grad((out[0] ** 2).sum() + out[2].sum() + out[3].sum(),
                                 [og, dg])
    assert torch.equal(ga, torch.zeros_like(o)) and torch.equal(gb, torch.zeros_like(d))

    def f(o_, d_):
        t, _, u, v = kernels.sweep_nearest_stopgrad_tri_fn(Rays(o=o_, d=d_), *args)
        return t, u, v

    primal, tangents = torch.func.jvp(f, (o, d), (torch.ones_like(o), torch.ones_like(d)))
    assert all(torch.equal(p, r) for p, r in zip(primal, (ref[0], ref[2], ref[3])))
    assert all(torch.equal(t, torch.zeros_like(t)) for t in tangents)


def test_occluded_honours_detached_ok():
    """Shadow rays of a pipeline whose sweep is ``detached_ok`` go through
    the boolean any-hit kernel's wrapper (here its plain version), not a
    nearest-hit sweep; a plain ``tri_fn`` keeps its own sweep."""
    tt, _ = _t_cornell()
    n = 64
    o = torch.from_numpy(np.tile(np.float32([278.0, 273.0, -600.0]), (n, 1)))
    d = torch.from_numpy(np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1)))
    t_max = torch.full((n,), 2000.0)
    kernels.reset_counts()
    a = occluded(tt, Rays(o=o, d=d), t_max,
                 tri_fn=kernels.sweep_nearest_stopgrad_tri_fn,
                 present=tables_present(tt))
    c = kernels.counts()
    assert c["occluded_anyhit"]["plain_calls"] == 1
    assert c["sweep_nearest"]["plain_calls"] == 0
    b = occluded(tt, Rays(o=o, d=d), t_max, tri_fn=intersect_triangles_mm,
                 present=tables_present(tt))
    assert kernels.counts()["occluded_anyhit"]["plain_calls"] == 1
    assert torch.equal(a, b) and bool(a.any())


def test_routing_of_the_analytic_route():
    tt, st = _t_cornell()
    cam = PinholeCamera.make(4 / 3, device="cpu", **tpresets.cornell_camera())
    # CPU tables: no fast route unless forced
    assert diff.try_make_fast_value_and_grad(tt, st, cam, 4, 3) is None
    assert mk.try_make_fused_grad_path(tt, st, 3) is None
    # a forced route reports its sizes; depth 9 is over the kernel's limit
    f = mk.try_make_fused_grad_path(tt, st, 3, force=True)
    assert (f.n_mats, f.n_lights, f.grad_scene.n_planes) == (3, 1, 33)
    assert mk.try_make_fused_grad_path(tt, st, 9, force=True) is None
    # more materials than the kernel carries
    many = tt._replace(mat_albedo=torch.rand((mk.MAX_GRAD_MATS + 1, 3)))
    assert mk.try_make_fused_grad_path(many, st, 3, force=True) is None
    # volume scenes: a homogeneous box (vpt) has no analytic route; a cloud
    # lit by a sphere takes the heterogeneous one (K9a + K10), forced here
    from xraytracer_tpu_torch import cli

    vt, vcam = cli.build_scene(get_preset("vpt", width=8, height=8), device="cpu")
    vst = tbuilder.scene_statics(vt)
    vc = PinholeCamera.make(1.0, device="cpu", **vcam)
    assert diff.try_make_fast_value_and_grad(vt, vst, vc, 8, 8, force=True) is None
    ct, ccam = cli.build_scene(get_preset("nee", width=8, height=6), device="cpu")
    cst = tbuilder.scene_statics(ct)
    cc = PinholeCamera.make(8 / 6, device="cpu", **ccam)
    assert diff.try_make_fast_value_and_grad(ct, cst, cc, 8, 6, max_depth=2) is None
    step = diff.try_make_fast_value_and_grad(ct, cst, cc, 8, 6, max_depth=2, force=True)
    assert step is not None and step.n_lights == 1 and callable(step.step_pair)
    assert step.het_consts.grad_sampling and step.het_consts.max_depth == 2


def test_jax_tables_converted_give_the_same_gradients():
    """JAX tables -> numpy -> ``convert.tables_from_numpy``: the same
    gradients as the port's own builder."""
    jt, _ = _j_cornell()
    conv = convert.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()}, device="cpu")
    out = []
    for tables in (None, conv):
        tt, st, cam, radiance, ids, xy = _t_setup(16, 12, 2, tables=tables)
        loss = diff.make_loss_fn(radiance)
        params = {"mat_albedo": tt.mat_albedo, "al_le": tt.al_le}
        out.append(diff.value_and_grad(loss)(params, ids, xy,
                                             torch.zeros((16 * 12, 3)), 0))
    (v0, g0), (v1, g1) = out
    assert float(v0) == float(v1)
    for k in g0:
        assert torch.equal(g0[k], g1[k])
