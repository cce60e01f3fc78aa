"""Port parity, step 8-9: BSDFs and area lights of ``xraytracer_tpu_torch``
against the JAX package on the same random numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xraytracer_tpu import lights as jlights
from xraytracer_tpu import materials as jmat
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu_torch import convert
from xraytracer_tpu_torch import lights as tlights
from xraytracer_tpu_torch import materials as tmat

torch.set_num_threads(1)

N = 6000
# elementwise float32 formulas on both sides; transcendentals (sin/cos/sqrt)
# and XLA's fused multiply-adds differ by a few ulp, amplified where a
# formula cancels (Fresnel near grazing, pdfs over small |d.n|)
TOL = dict(rtol=2e-5, atol=2e-6)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def scene_pair():
    b = jbuilder.SceneBuilder()
    m0 = b.add_lambert((0.2, 0.4, 0.6))
    m1 = b.add_mirror()
    m2 = b.add_glass(1.5)
    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    for m in (m0, m1, m2):
        b.add_mesh(tri + m, material=m)
    b.add_triangle_light((0, 5, 0), (1, 5, 0), (0, 5, 1.5), (3.0, 2.0, 1.0))
    b.add_quad_light((-1, 4, -1), (1, 4, -1), (-1, 4, 1), (5.0, 5.0, 5.0))
    b.add_sphere_light((4, 4, 4), 0.75, (7.0, 6.0, 5.0))
    jt = b.build()
    tt = convert.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()}, device="cpu")
    return jt, tt


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(0)
    wo = _unit(rng, N)
    wi = _unit(rng, N)
    mtype = rng.integers(-1, 3, N).astype(np.int32)
    albedo = rng.random((N, 3)).astype(np.float32)
    ior = rng.uniform(1.1, 1.8, N).astype(np.float32)
    u2 = rng.random((N, 2)).astype(np.float32)
    ul = rng.random(N).astype(np.float32)
    return wo, wi, mtype, albedo, ior, u2, ul


def test_eval_and_pdf_match(lanes):
    wo, wi, mtype, albedo, _, _, _ = lanes
    np.testing.assert_allclose(
        tmat.eval_bsdf_direct(_t(mtype), _t(albedo), _t(wo), _t(wi)).numpy(),
        np.asarray(jmat.eval_bsdf_direct(jnp.asarray(mtype), jnp.asarray(albedo),
                                         jnp.asarray(wo), jnp.asarray(wi))), **TOL)
    for cosine in (False, True):
        np.testing.assert_allclose(
            tmat.bsdf_pdf_direct(_t(mtype), _t(wo), _t(wi), cosine).numpy(),
            np.asarray(jmat.bsdf_pdf_direct(jnp.asarray(mtype), jnp.asarray(wo),
                                            jnp.asarray(wi), cosine)), **TOL)


@pytest.mark.parametrize("cosine", [False, True])
def test_sample_bsdf_direct_matches(lanes, cosine):
    wo, _, mtype, albedo, ior, u2, ul = lanes
    js = jmat.sample_bsdf_direct(
        jnp.asarray(mtype), jnp.asarray(albedo), jnp.asarray(ior),
        jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(ul), cosine)
    ts = tmat.sample_bsdf_direct(
        _t(mtype), _t(albedo), _t(ior), _t(wo), _t(u2), _t(ul), cosine)
    np.testing.assert_array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
    # the glass lobe choice compares u against a Fresnel term: lanes within
    # rounding of it may pick the other lobe
    same = ts.flip_side.numpy() == np.asarray(js.flip_side)
    assert (~same).sum() <= 2
    np.testing.assert_allclose(ts.wi.numpy()[same], np.asarray(js.wi)[same],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), **TOL)
    np.testing.assert_allclose(ts.pdf.numpy(), np.asarray(js.pdf), **TOL)
    assert ts.flip_side.sum() > 100  # glass transmission lanes exercised


def test_object_id_wrappers_match(scene_pair, lanes):
    jt, tt = scene_pair
    wo, wi, _, _, _, u2, ul = lanes
    obj = np.random.default_rng(1).integers(-1, 6, N).astype(np.int32)
    np.testing.assert_allclose(
        tmat.eval_bsdf(tt, _t(obj), _t(wo), _t(wi)).numpy(),
        np.asarray(jmat.eval_bsdf(jt, jnp.asarray(obj), jnp.asarray(wo),
                                  jnp.asarray(wi))), **TOL)
    np.testing.assert_allclose(
        tmat.bsdf_pdf(tt, _t(obj), _t(wo), _t(wi), True).numpy(),
        np.asarray(jmat.bsdf_pdf(jt, jnp.asarray(obj), jnp.asarray(wo),
                                 jnp.asarray(wi), True)), **TOL)
    js = jmat.sample_bsdf(jt, jnp.asarray(obj), jnp.asarray(wo),
                          jnp.asarray(u2), jnp.asarray(ul))
    ts = tmat.sample_bsdf(tt, _t(obj), _t(wo), _t(u2), _t(ul))
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), **TOL)


@pytest.mark.parametrize("strategy", ["cone", "intersect", "area"])
def test_sample_area_light_matches(scene_pair, strategy):
    """All three light types (rows 0 triangle, 1 quad, 2 sphere, plus the
    -1 sentinel) under each sphere strategy."""
    jt, tt = scene_pair
    rng = np.random.default_rng(2)
    lidx = rng.integers(-1, 3, N).astype(np.int32)
    pos = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    u2 = rng.random((N, 2)).astype(np.float32)
    js = jlights.sample_area_light(jt, jnp.asarray(lidx), jnp.asarray(pos),
                                   jnp.asarray(u2), sphere_strategy=strategy)
    ts = tlights.sample_area_light(tt, _t(lidx), _t(pos), _t(u2),
                                   sphere_strategy=strategy)
    np.testing.assert_allclose(ts.wi.numpy(), np.asarray(js.wi), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.t_max.numpy(), np.asarray(js.t_max), rtol=1e-4, atol=1e-4)
    # pdf = t^3 / |d.n|: relative error grows as the denominator cancels
    np.testing.assert_allclose(ts.pdf.numpy(), np.asarray(js.pdf), rtol=2e-3, atol=1e-5)
    le_same = np.all(ts.le.numpy() == np.asarray(js.le), axis=-1)
    assert (~le_same).sum() <= 2  # front/back flips at grazing samples
    assert (ts.le.numpy().sum(axis=-1) > 0).sum() > N // 4


def test_area_light_le_and_direction_pdf_match(scene_pair):
    jt, tt = scene_pair
    rng = np.random.default_rng(3)
    lidx = rng.integers(-1, 3, N).astype(np.int32)
    wo, ns = _unit(rng, N), _unit(rng, N)
    np.testing.assert_array_equal(
        tlights.area_light_le(tt, _t(lidx), _t(wo), _t(ns)).numpy(),
        np.asarray(jlights.area_light_le(jt, jnp.asarray(lidx), jnp.asarray(wo),
                                         jnp.asarray(ns))))
    pos = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    t_hit = rng.uniform(0.5, 9.0, N).astype(np.float32)
    np.testing.assert_allclose(
        tlights.light_pdf_for_direction(tt, _t(lidx), _t(pos), _t(wo), _t(t_hit)).numpy(),
        np.asarray(jlights.light_pdf_for_direction(
            jt, jnp.asarray(lidx), jnp.asarray(pos), jnp.asarray(wo),
            jnp.asarray(t_hit))), rtol=2e-3, atol=1e-5)


def test_power_weights_and_uniform_pick_match(scene_pair):
    jt, tt = scene_pair
    np.testing.assert_array_equal(tlights.light_power_weights(tt),
                                  jlights.light_power_weights(jt))
    u = np.random.default_rng(4).random(N).astype(np.float32)
    u[:2] = (0.0, 1.0 - 2.0 ** -24)
    for n_lights in (1, 3, 7):
        ji, jp = jlights.pick_uniform_light(n_lights, jnp.asarray(u))
        ti, tp = tlights.pick_uniform_light(n_lights, _t(u))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert tp == jp
