"""Port parity, volume gradients: the port's ``differentiable`` /
``score_terms`` volume integrator and its analytic route
(``het_megakernel.try_make_fused_het_value_and_grad``: pass A ``het_path``,
pass B ``het_grad_path``) against ``jax.value_and_grad`` of the JAX
package's wavefront volume integrator, same scenes, rays and draws.

On CPU tensors the kernels' wrappers take their plain versions: autograd
through the port's wavefront route (the CUDA kernel K10 is held against
that same plain version on the card by ``chip_smoke.py``). The JAX side is
its XLA wavefront under ``jax.jit`` with ``unroll=False`` (one compiled
iteration body), differentiated in FORWARD mode (``jax.jacfwd``): the same
derivatives as ``jax.value_and_grad`` (both are exact derivatives of the
same float32 program), for about half the tracing and compiling time of
the reverse-mode scan on the CPU (~40 s against ~65 s for the two
configurations of ``test_diff_volume.py``'s scene). No JAX descent and no
JAX kernel in interpret mode runs here: the file is held to 75 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xraytracer_tpu.camera import PinholeCamera as JCamera
from xraytracer_tpu.geometry import Rays as JRays
from xraytracer_tpu.integrators import make_volume_integrator as j_make_volume
from xraytracer_tpu.math import from_rows as j_from_rows
from xraytracer_tpu.renderer import CAMERA_SITE as J_CAMERA_SITE
from xraytracer_tpu.renderer import pixel_grid as j_pixel_grid
from xraytracer_tpu.sampling import path_keys as j_path_keys
from xraytracer_tpu.sampling import uniform2 as j_uniform2
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu_torch import convert, diff
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.integrators import het_megakernel as hk
from xraytracer_tpu_torch.integrators import make_volume_integrator
from xraytracer_tpu_torch.math import from_rows
from xraytracer_tpu_torch.renderer import pixel_grid
from xraytracer_tpu_torch.scene import builder as tbuilder
from xraytracer_tpu_torch.scene import presets as tpresets
from xraytracer_tpu_torch.tools import fit_volume

torch.set_num_threads(1)

W, H = 8, 6
HET_C2W = (1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 4.0, 1)
CLOUD_C2W = (1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 60.0, 520.0, 1)
CLOUD_DEPTH, CLOUD_STEPS = 3, 16
# Same draws, same decisions; what differs is float32 rounding (exp / log of
# two math libraries, a few products in another order) and the order in
# which a cell's events are summed: rtol 1e-4 / atol 1e-5 x the largest
# entry, well inside the JAX package's analytic-gradient gate (5e-3 / 5e-4)
RTOL, ATOL_REL = 1e-4, 1e-5


def _hetero(builder):
    """tests/test_diff_volume.py::_hetero_scene: a 4^3 grid in a box under a
    quad light."""
    b = builder()
    grid = np.full((4, 4, 4), 0.6, np.float32)
    grid[1:3, 1:3, 1:3] = 1.0
    b.set_density_grid(grid, (-1, -1, -1), (1, 1, 1))
    b.add_heterogeneous_medium(0.0, (0.2, 0.2, 0.2), (0.4, 0.4, 0.4))
    b.add_quad_light((0.5, 1.6, 0.5), (-0.5, 1.6, 0.5), (0.5, 1.6, -0.5),
                     (8.0, 8.0, 8.0))
    return b


def _cloud_kwargs():
    """A small sphere-lit cloud (the scene of tests/test_het_grad_kernel.py
    at 8^3): seeded densities in the inner 6^3 voxels."""
    g = np.zeros((8, 8, 8), np.float32)
    g[1:7, 1:7, 1:7] = np.random.default_rng(7).uniform(0.3, 1.0, (6, 6, 6))
    return g, dict(res=g.shape, density=g, absorption=(0.02, 0.03, 0.04),
                   scattering=(0.10, 0.08, 0.06), le=25.0,
                   light_center=(0.0, 400.0, 0.0))


def _close(got, want, what):
    want = np.asarray(want)
    got = np.asarray(got)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * scale, err_msg=what)


# --------------------------------------------------------------------------
# the autograd route: test_diff_volume.py's scene
# --------------------------------------------------------------------------
PARAMS = ("med_sigma_s", "med_sigma_a", "grid_density", "al_le")


def _hetero_jax(nee):
    """The mean radiance and its gradient w.r.t. the parameters
    (``jax.jacfwd``), all in one compiled call (depth 3, max_steps 24)."""
    jt = _hetero(jbuilder.SceneBuilder).build()
    st = jbuilder.scene_statics(jt)
    cam = JCamera.make(W / H, c2w=j_from_rows(*HET_C2W), fov_deg=50.0)
    ids, xy = j_pixel_grid(W, H)
    wh = jnp.asarray([float(W), float(H)])

    def f(p):
        integ = j_make_volume(jt._replace(**p), st, 3, nee=nee, max_steps=24,
                              differentiable=True, unroll=False)
        keys = j_path_keys(0, ids, 0)
        rays = cam.sample_rays((xy + j_uniform2(keys, J_CAMERA_SITE)) / wh)
        return jnp.mean(integ(rays, keys))

    def f_aux(p):
        v = f(p)
        return v, v

    g, val = jax.jit(jax.jacfwd(f_aux, has_aux=True))({k: getattr(jt, k) for k in PARAMS})
    return float(val), {k: np.asarray(v) for k, v in g.items()}


@pytest.fixture(scope="module")
def hetero_ref():
    """NEE off and on: (value, gradients)."""
    return {nee: _hetero_jax(nee) for nee in (False, True)}


def _port_hetero_radiance(nee, **kw):
    tt = _hetero(tbuilder.SceneBuilder).build("cpu")
    st = tbuilder.scene_statics(tt)
    cam = PinholeCamera.make(W / H, c2w=from_rows(*HET_C2W), fov_deg=50.0, device="cpu")
    ids, xy = pixel_grid(W, H, device="cpu")
    radiance = diff.make_radiance_fn(tt, st, cam, W, H, max_depth=3, nee=nee,
                                     max_steps=24, **kw)
    return tt, radiance, ids, xy


def _mean_radiance(radiance, ids, xy):
    return lambda p: torch.mean(radiance(p, ids, xy, 0))


@pytest.mark.parametrize("kw", [dict(), dict(score_terms=True),
                                dict(score_terms=True, grad_sampling=True)],
                         ids=["differentiable", "score_terms", "grad_sampling"])
def test_differentiable_forward_is_the_default_forward(kw):
    """``differentiable`` reads the dense grid where the default route reads
    the corner table: the same eight corner values, added in the same
    order, so the images are bitwise equal; the score ratios are exactly
    1."""
    tt, radiance, ids, xy = _port_hetero_radiance(True, **kw)
    st = tbuilder.scene_statics(tt)
    cam = PinholeCamera.make(W / H, c2w=from_rows(*HET_C2W), fov_deg=50.0, device="cpu")
    got = radiance({}, ids, xy, 0)
    plain = make_volume_integrator(tt, st, 3, nee=True, max_steps=24, fused="never",
                                   grad_sampling=kw.get("grad_sampling", False))
    from xraytracer_tpu_torch.renderer import CAMERA_SITE
    from xraytracer_tpu_torch.sampling import path_keys, uniform2

    keys = path_keys(0, ids, 0)
    rays = cam.sample_rays((xy + uniform2(keys, CAMERA_SITE)) / torch.tensor([float(W), float(H)]))
    want = plain(rays, keys)
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    assert float(want.mean()) > 1e-3


def test_fit_volume_takes_steps_on_the_cpu():
    """``tools.fit_volume.fit`` on the CPU (the plain versions) for 2 steps
    at a tiny size: finite losses and gradients, the grid's shape, the
    published defaults."""
    import inspect

    defaults = {k: v.default for k, v in inspect.signature(fit_volume.fit).parameters.items()}
    assert (defaults["width"], defaults["height"], defaults["steps"], defaults["lr"],
            defaults["max_depth"], defaults["pairs"], defaults["target_pairs"]) == (
        96, 72, 600, 0.1, 6, 2, 64)
    stats = {}
    hist, fitted, tgt = fit_volume.fit(width=6, height=4, steps=2, max_depth=1, pairs=1,
                                       target_pairs=1, device="cpu", stats=stats)
    assert len(hist) == 2 and np.isfinite(hist).all()
    assert fitted.shape == tgt.shape == (16, 16, 16) and np.isfinite(fitted).all()
    assert stats["grads_finite"] and stats["n_rejected"] == 0 and len(stats["mae"]) == 3
    assert len(stats["eval_loss"]) == 2 and np.isfinite(stats["eval_loss"]).all()
    assert 0.0 < fitted.min() and fitted.max() < 1.0


@pytest.mark.parametrize("nee", [False, True], ids=["nee_off", "nee_on"])
def test_autograd_gradients_match_jax(hetero_ref, nee):
    """d mean(radiance) / d {med_sigma_s, grid_density, al_le} by autograd
    against the JAX package's derivatives. The port holds the majorants
    fixed (a sampling choice), the JAX package differentiates them too, so
    that every tracked point moves with sigma_t (its reverse mode gives NaN
    d / d sigma with NEE: square roots of 0 in the light sample at the
    moved points). Along sigma_s + e, sigma_a - e the majorant and every
    tracked point stay put, so d / d sigma_s - d / d sigma_a is the same
    quantity on both sides: that is what is held for sigma, against JAX
    and against a central difference of the port's own renders."""
    jval, jg = hetero_ref[nee]
    tt, radiance, ids, xy = _port_hetero_radiance(nee)
    f = _mean_radiance(radiance, ids, xy)
    val, g = diff.value_and_grad(f)({k: getattr(tt, k) for k in PARAMS})
    np.testing.assert_allclose(float(val), jval, rtol=RTOL)
    for k in PARAMS:
        assert bool(torch.isfinite(g[k]).all()), k
    for k in ("grid_density", "al_le"):
        _close(g[k].numpy(), jg[k], k)
    dsig = (g["med_sigma_s"] - g["med_sigma_a"]).numpy()
    _close(dsig, jg["med_sigma_s"] - jg["med_sigma_a"], "sigma_s - sigma_a")
    if not nee:
        assert float(val) == 0.0      # the camera sees the light only through NEE
        return
    assert float(torch.abs(g["grid_density"]).max()) > 0.0
    assert float(np.abs(dsig).max()) > 0.0
    eps = 5e-3
    for c in range(3):
        def shifted(e):
            ss, sa = tt.med_sigma_s.clone(), tt.med_sigma_a.clone()
            ss[0, c] += e
            sa[0, c] -= e
            return float(f({"med_sigma_s": ss, "med_sigma_a": sa}))

        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
        ad = float(g["med_sigma_s"][0, c] - g["med_sigma_a"][0, c])
        assert abs(fd - ad) <= max(2e-4, 0.08 * abs(fd)), (c, fd, ad)


# --------------------------------------------------------------------------
# the analytic route (K10's plain version) on a sphere-lit cloud
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cloud_ref():
    return _cloud_jax()


def _cloud_jax():
    """The JAX wavefront (differentiable, score_terms, grad_sampling) on the
    small cloud: the images and the gradients of ``step`` (sample 0, stream
    0) and ``step_pair`` (samples 4 and 5, streams 0 and 7919) for the grid
    and Le, contracted from the Jacobians of the images (``jax.jacfwd``,
    one compiled function for the three ray sets)."""
    g, kw = _cloud_kwargs()
    jt = jpresets.build_volume_scene(**kw).build()
    st = jbuilder.scene_statics(jt)
    cam = JCamera.make(W / H, c2w=j_from_rows(*CLOUD_C2W), fov_deg=60.0)
    ids, xy = j_pixel_grid(W, H)
    wh = jnp.asarray([float(W), float(H)])
    params = {"grid_density": jnp.asarray(g), "al_le": jt.al_le}

    @jax.jit
    def img_and_jac(p, o, d, keys):
        def render(p):
            integ = j_make_volume(jt._replace(**p), st, CLOUD_DEPTH, nee=True,
                                  max_steps=CLOUD_STEPS, differentiable=True,
                                  score_terms=True, grad_sampling=True, fused="off",
                                  unroll=False)
            return integ(JRays(o=o, d=d), keys)

        def render_aux(p):
            img = render(p)
            return img, img

        jac, img = jax.jacfwd(render_aux, has_aux=True)(p)
        return img, jac

    def rays(seed, s):
        keys = j_path_keys(seed, ids, s)
        r = cam.sample_rays((xy + j_uniform2(keys, J_CAMERA_SITE)) / wh)
        return r.o, r.d, keys

    def contract(jac, ct):
        return {k: np.einsum("nc,nc...->...", np.asarray(ct), np.asarray(v))
                for k, v in jac.items()}

    n = W * H
    img0, jac0 = img_and_jac(params, *rays(0, 0))
    ia, jaca = img_and_jac(params, *rays(0, 4))
    ib, jacb = img_and_jac(params, *rays(7919, 5))
    img0, ia, ib = np.asarray(img0), np.asarray(ia), np.asarray(ib)
    t_step, t_pair = img0 * 0.7 + 0.01, img0 * 0.6 + 0.02
    ga = contract(jaca, (ib - t_pair) / (n * 3))
    gb = contract(jacb, (ia - t_pair) / (n * 3))
    return dict(
        tables=jt, grid=g, img0=img0,
        step=(float(np.mean((img0 - t_step) ** 2)),
              contract(jac0, 2.0 * (img0 - t_step) / (n * 3)), t_step),
        pair=(float(np.mean((ia - t_pair) * (ib - t_pair))),
              {k: ga[k] + gb[k] for k in ga}, t_pair),
    )


def _port_step(tables):
    """The analytic route on CPU tables (``force``: the plain versions)."""
    st = tbuilder.scene_statics(tables)
    cam = PinholeCamera.make(W / H, c2w=from_rows(*CLOUD_C2W), fov_deg=60.0, device="cpu")
    return hk.try_make_fused_het_value_and_grad(
        tables, st, cam, W, H, CLOUD_DEPTH, nee=True, max_steps=CLOUD_STEPS, force=True)


def _check_step(got, want):
    loss, grads = got
    wloss, wgrads = want[0], want[1]
    np.testing.assert_allclose(float(loss), wloss, rtol=RTOL)
    assert np.abs(wgrads["grid_density"]).max() > 0.0
    for k in grads:
        _close(grads[k].numpy(), wgrads[k], k)


def test_analytic_step_matches_jax(cloud_ref):
    """``step`` (L2 loss) and ``step.step_pair`` (the two-sample product
    loss) of the analytic route, here the plain versions of K9a and K10,
    against the JAX wavefront's vector-Jacobian products on the same draws,
    at the JAX package's own gates (tests/test_het_grad_kernel.py) and at
    RTOL / ATOL_REL."""
    tt = tpresets.build_volume_scene(**_cloud_kwargs()[1]).build("cpu")
    step = _port_step(tt)
    ids, xy = pixel_grid(W, H, device="cpu")
    params = {"grid_density": torch.from_numpy(cloud_ref["grid"]), "al_le": tt.al_le}
    hk.reset_counts()
    got = step(params, ids, xy, torch.from_numpy(cloud_ref["step"][2]), 0)
    _check_step(got, cloud_ref["step"])
    assert hk.counts()["het_grad_path"]["plain_calls"] == 1
    assert hk.counts()["het_path"]["plain_calls"] == 1
    aux = {}
    got = step.step_pair({"grid_density": params["grid_density"]}, ids, xy,
                         torch.from_numpy(cloud_ref["pair"][2]), 4, 5, aux=aux)
    _check_step(got, cloud_ref["pair"])
    assert set(got[1]) == {"grid_density"} and aux["img_b"].shape == (W * H, 3)
    # pass A alone renders what the JAX wavefront renders
    img = step.render(params["grid_density"], ids, xy, 0)
    np.testing.assert_allclose(img.numpy(), cloud_ref["img0"], rtol=RTOL, atol=1e-6)


def test_converted_jax_tables_give_the_same_gradients(cloud_ref):
    """JAX tables -> numpy -> ``convert.tables_from_numpy``: the analytic
    step gives bitwise the port-built tables' gradients, and so JAX's."""
    conv = convert.tables_from_numpy(
        {k: np.asarray(v) for k, v in cloud_ref["tables"]._asdict().items()}, device="cpu")
    own = tpresets.build_volume_scene(**_cloud_kwargs()[1]).build("cpu")
    ids, xy = pixel_grid(W, H, device="cpu")
    target = torch.from_numpy(cloud_ref["step"][2])
    out = []
    for tables in (conv, own):
        step = _port_step(tables)
        out.append(step({"grid_density": tables.grid_density}, ids, xy, target, 0))
    (l0, g0), (l1, g1) = out
    assert float(l0) == float(l1)
    assert torch.equal(g0["grid_density"], g1["grid_density"])
    _check_step(out[0], (cloud_ref["step"][0], {"grid_density": cloud_ref["step"][1]["grid_density"]}))
