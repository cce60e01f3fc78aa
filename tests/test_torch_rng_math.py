"""Port parity, step 1-2: RNG (bitwise), vector/transform math, warps and
the discrete distribution of ``xraytracer_tpu_torch`` against the JAX
package on the same numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xraytracer_tpu.math import transform as jtf
from xraytracer_tpu.math import vec as jvec
from xraytracer_tpu.sampling import distribution as jdist
from xraytracer_tpu.sampling import rng as jrng
from xraytracer_tpu.sampling import warps as jwarps
from xraytracer_tpu_torch.math import transform as ttf
from xraytracer_tpu_torch.math import vec as tvec
from xraytracer_tpu_torch.sampling import distribution as tdist
from xraytracer_tpu_torch.sampling import rng as trng
from xraytracer_tpu_torch.sampling import warps as twarps

torch.set_num_threads(1)

N_LANES = 1 << 20  # >= 1M (pixel, sample, site) lanes


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x)


def _pixel_ids():
    """1M int32 pixel ids, a quarter of them with the top bit set."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1 << 31, N_LANES, dtype=np.int64)
    ids[::4] |= 1 << 31
    return ids.astype(np.uint32).view(np.int32)


@pytest.fixture(scope="module")
def keys():
    ids = _pixel_ids()
    jk = jrng.path_keys(12345, jnp.asarray(ids), 7)
    tk = trng.path_keys(12345, _t(ids), 7)
    return jk, tk


def test_pcg_edge_words_bitwise():
    words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x9E3779B9],
                     np.uint32)
    j = _np(jrng._pcg(jnp.asarray(words)))
    t = trng._pcg(_t(words.astype(np.int64))).numpy()
    np.testing.assert_array_equal(t, j.astype(np.int64))
    for w in words:
        assert trng._pcg(int(w)) == int(_np(jrng._pcg(jnp.uint32(w))))


@pytest.mark.parametrize("seed,sample", [(0, 0), (12345, 7), (0xFFFFFFFF, 511)])
def test_path_keys_bitwise(seed, sample):
    ids = _pixel_ids()
    j = _np(jrng.path_keys(seed, jnp.asarray(ids), sample))
    t = trng.path_keys(seed, _t(ids), sample).numpy()
    assert t.min() >= 0 and t.max() < 2 ** 32
    np.testing.assert_array_equal(t.astype(np.uint32), j)
    # a tensor sample index hashes like the Python int
    t2 = trng.path_keys(seed, _t(ids[:1000]), torch.tensor(sample)).numpy()
    np.testing.assert_array_equal(t2, t[:1000])


# sites: bounce blocks, the camera site, and sites with the top bit set
SITES = [0, 1, 16, 2 * (1 << 16) + 17, 0x7FFF0000, 0x80000001, 0xFFFF0000]


@pytest.mark.parametrize("site", SITES)
def test_uniform1_bitwise(keys, site):
    jk, tk = keys
    j = _np(jrng.uniform1(jk, np.uint32(site)))
    t = trng.uniform1(tk, site).numpy()
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("site", SITES)
def test_uniform2_bitwise(keys, site):
    jk, tk = keys
    np.testing.assert_array_equal(
        trng.uniform2(tk, site).numpy(), _np(jrng.uniform2(jk, np.uint32(site)))
    )


@pytest.mark.parametrize("site", SITES)
def test_uniform3_bitwise(keys, site):
    jk, tk = keys
    np.testing.assert_array_equal(
        trng.uniform3(tk, site).numpy(), _np(jrng.uniform3(jk, np.uint32(site)))
    )


def test_uniform_tensor_site_matches_int_site(keys):
    _, tk = keys
    for site in SITES:
        a = trng.uniform1(tk[:4096], site)
        b = trng.uniform1(tk[:4096], torch.tensor(site, dtype=torch.int64))
        assert torch.equal(a, b)


@pytest.mark.parametrize("key,site,shape", [
    (0, 0, ()), (0xDEADBEEF, 3, (5,)), (0xFFFFFFFF, 0x80000001, (4, 3)),
])
def test_scalar_uniform_bitwise(key, site, shape):
    j = _np(jrng.scalar_uniform(np.uint32(key), np.uint32(site), shape))
    t = trng.scalar_uniform(key, site, shape).numpy()
    np.testing.assert_array_equal(t, j)


def test_base_key_and_constants():
    assert trng.SITES_PER_BOUNCE == jrng.SITES_PER_BOUNCE == 1 << 16
    for seed in (0, 1, 12345, 0xFFFFFFFF):
        assert trng.base_key(seed) == int(_np(jrng.base_key(seed)))


# --- vector / transform / warps: float parity to 1e-6 (both sides are f32
# elementwise formulas; only libm-vs-XLA transcendentals and fused
# multiply-adds differ, a few ulp on O(1) values) -------------------------
TOL = dict(rtol=1e-6, atol=1e-6)


def _vecs(n=4096, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    unit = a / np.linalg.norm(a, axis=-1, keepdims=True)
    return a, b, unit.astype(np.float32)


def test_vec_ops_match():
    a, b, unit = _vecs()
    for name in ("dot", "dot_keep", "cross", "vmin", "vmax"):
        np.testing.assert_allclose(
            getattr(tvec, name)(_t(a), _t(b)).numpy(),
            _np(getattr(jvec, name)(jnp.asarray(a), jnp.asarray(b))), **TOL)
    for name in ("length", "length2", "normalize"):
        np.testing.assert_allclose(
            getattr(tvec, name)(_t(a)).numpy(),
            _np(getattr(jvec, name)(jnp.asarray(a))), rtol=1e-6, atol=1e-5)
    for tt, jj in zip(tvec.orthonormal_basis(_t(unit)),
                      jvec.orthonormal_basis(jnp.asarray(unit))):
        np.testing.assert_allclose(tt.numpy(), _np(jj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tvec.reflect(_t(a), _t(unit)).numpy(),
        _np(jvec.reflect(jnp.asarray(a), jnp.asarray(unit))), rtol=1e-5, atol=1e-5)


def test_normalize_zero_is_nan_and_eps_guard():
    z = torch.zeros((2, 3))
    assert torch.isnan(tvec.normalize(z)).all()
    assert torch.equal(tvec.normalize(z, eps=1e-20), z)


def test_refract_fresnel_frames_match():
    a, b, unit = _vecs(seed=2)
    i = b / np.linalg.norm(b, axis=-1, keepdims=True)
    for ior in (1.3, np.full((a.shape[0],), 1.5, np.float32)):
        t_ior = ior if np.isscalar(ior) else _t(ior)
        j_ior = ior if np.isscalar(ior) else jnp.asarray(ior)
        np.testing.assert_allclose(
            tvec.refract(_t(i), _t(unit), t_ior).numpy(),
            _np(jvec.refract(jnp.asarray(i), jnp.asarray(unit), j_ior)),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tvec.fresnel(_t(i), _t(unit), t_ior).numpy(),
            _np(jvec.fresnel(jnp.asarray(i), jnp.asarray(unit), j_ior)),
            rtol=1e-4, atol=1e-5)
    tb = tvec.orthonormal_basis(_t(unit))
    jb = jvec.orthonormal_basis(jnp.asarray(unit))
    wl = tvec.world_to_local(_t(a), tb[0], _t(unit), tb[1])
    np.testing.assert_allclose(
        wl.numpy(),
        _np(jvec.world_to_local(jnp.asarray(a), jb[0], jnp.asarray(unit), jb[1])),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tvec.local_to_world(wl, tb[0], _t(unit), tb[1]).numpy(), a,
        rtol=1e-4, atol=1e-4)


def test_transforms_match():
    rows = [1.0, 0, 0, 0, 0, 0.5, 0.2, 0, 0.1, 0, -1.0, 0, 278, 274.4, -750.0, 1]
    m_t, m_j = ttf.from_rows(*rows), jtf.from_rows(*rows)
    np.testing.assert_array_equal(m_t, _np(m_j))
    np.testing.assert_array_equal(ttf.identity(), _np(jtf.identity()))
    np.testing.assert_array_equal(ttf.translation((1, 2, 3)),
                                  _np(jtf.translation((1, 2, 3))))
    np.testing.assert_allclose(ttf.look_at((0, 1, 5), (0, 0, 0)),
                               _np(jtf.look_at((0, 1, 5), (0, 0, 0))), **TOL)
    assert m_t[3, 0] == 278.0  # row-vector convention: translation in row 3
    a, _, _ = _vecs(n=512, seed=3)
    np.testing.assert_allclose(
        ttf.transform_point(_t(m_t), _t(a)).numpy(),
        _np(jtf.transform_point(m_j, jnp.asarray(a))), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        ttf.transform_dir(_t(m_t), _t(a)).numpy(),
        _np(jtf.transform_dir(m_j, jnp.asarray(a))), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        ttf.inverse(_t(m_t)).numpy(), _np(jtf.inverse(m_j)), rtol=1e-4, atol=1e-4)


def test_warps_match():
    rng = np.random.default_rng(4)
    n = 8192
    u1 = rng.random(n).astype(np.float32)
    u2 = rng.random(n).astype(np.float32)
    for name in ("uniform_hemisphere", "cosine_hemisphere", "uniform_sphere"):
        np.testing.assert_allclose(
            getattr(twarps, name)(_t(u1), _t(u2)).numpy(),
            _np(getattr(jwarps, name)(jnp.asarray(u1), jnp.asarray(u2))), **TOL)
    a, b, unit = _vecs(n=n, seed=5)
    c = (a + b).astype(np.float32)
    np.testing.assert_allclose(
        twarps.uniform_triangle(_t(u1), _t(u2), _t(a), _t(b), _t(c)).numpy(),
        _np(jwarps.uniform_triangle(jnp.asarray(u1), jnp.asarray(u2),
                                    jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(c))), rtol=1e-5, atol=1e-5)
    tx, ty = tvec.orthonormal_basis(_t(unit))
    jx, jy = jvec.orthonormal_basis(jnp.asarray(unit))
    cmax = (0.5 + 0.5 * u2).astype(np.float32)
    np.testing.assert_allclose(
        twarps.uniform_cone(_t(u1), _t(u2), _t(cmax), tx, ty, _t(unit)).numpy(),
        _np(jwarps.uniform_cone(jnp.asarray(u1), jnp.asarray(u2),
                                jnp.asarray(cmax), jx, jy, jnp.asarray(unit))),
        rtol=1e-5, atol=1e-5)
    for g in (0.0, 0.6, -0.3):
        np.testing.assert_allclose(
            twarps.hg_sample_cos_theta(_t(u1), g).numpy(),
            _np(jwarps.hg_sample_cos_theta(jnp.asarray(u1), jnp.float32(g))),
            rtol=1e-5, atol=1e-5)
        ct = (2.0 * u2 - 1.0).astype(np.float32)
        np.testing.assert_allclose(
            twarps.hg_phase(_t(ct), g).numpy(),
            _np(jwarps.hg_phase(jnp.asarray(ct), jnp.float32(g))),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weights", [
    [1.0], [1.0, 2.0, 3.0, 4.0], [0.0, 5.0, 0.0, 1.0, 1e-3], [0.0, 0.0, 0.0],
    list(np.random.default_rng(6).random(37)),
])
def test_discrete_distribution_picks_equal(weights):
    rng = np.random.default_rng(7)
    u = np.concatenate([rng.random(20000).astype(np.float32),
                        np.array([0.0, 1.0 - 2.0 ** -24], np.float32)])
    jd = jdist.DiscreteDistribution1D(weights)
    td = tdist.DiscreteDistribution1D(weights)
    np.testing.assert_array_equal(td.cdf.numpy(), _np(jd.cdf))
    np.testing.assert_array_equal(td.pmf.numpy(), _np(jd.pmf))
    ji, jp = jd.sample(jnp.asarray(u))
    ti, tp = td.sample(_t(u))
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_array_equal(tp.numpy(), _np(jp))


def test_sample_channel_matches():
    rng = np.random.default_rng(8)
    vals = rng.random((4096, 3)).astype(np.float32)
    vals[:7] = 0.0
    u = rng.random(4096).astype(np.float32)
    jc, jp = jdist.sample_channel(jnp.asarray(vals), jnp.asarray(u))
    tc, tp = tdist.sample_channel(_t(vals), _t(u))
    np.testing.assert_allclose(tp.numpy(), _np(jp), **TOL)
    # a pick may differ only where u sits within rounding of a cdf knot
    differ = tc.numpy() != _np(jc)
    assert differ.sum() <= 1
