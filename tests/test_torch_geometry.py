"""Port parity, step 6-7: the module that holds the kernels. The same rays
and tables go through (a) the JAX classic sweep, (b) the JAX Pallas kernels
in interpret mode — as tests/test_pallas.py runs them — and (c) the port's
plain K2/K3/K4 versions and its ``intersect_scene``/``occluded`` (CPU).

The CUDA kernels themselves cannot run without a card; ``chip_smoke.py``
holds them against these plain versions on the card.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xraytracer_tpu.geometry import Rays as JRays
from xraytracer_tpu.geometry import intersect as jix
from xraytracer_tpu.geometry.pallas_kernels import (
    CHUNK_GROUP,
    intersect_triangles_pallas_rec,
    occluded_triangles_pallas,
)
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu_torch import convert
from xraytracer_tpu_torch.geometry import Rays as TRays
from xraytracer_tpu_torch.geometry import intersect as tix
from xraytracer_tpu_torch.geometry import kernels

torch.set_num_threads(1)

# formulation-level float noise (tests/test_pallas.py:57-69): the sweeps
# evaluate the expanded bilinear triple products, the classic path the
# factored form; relative error blows up only where u/v ~ 0
T_TOL = dict(rtol=1e-4, atol=1e-5)
UV_TOL = dict(rtol=2e-3, atol=1e-5)
REC_TOL = dict(rtol=1e-5, atol=1e-5)
TIE_BAND = 2.0 ** -15  # tests/test_pallas.py:113-128

N_RAYS = 389  # ragged: no multiple of any tile
SIZES = [32, 128, 256, (CHUNK_GROUP + 1) * 128]


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _random_tris(t_total, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-scale, scale, (t_total, 3)).astype(np.float32)
    e1 = rng.uniform(-1.5, 1.5, (t_total, 3)).astype(np.float32)
    e2 = rng.uniform(-1.5, 1.5, (t_total, 3)).astype(np.float32)
    valid = np.ones((t_total,), bool)
    valid[-3:] = False  # padding rows, like SceneBuilder emits
    rec = rng.normal(size=(t_total, 32)).astype(np.float32)
    return v0, e1, e2, valid, rec


def _random_rays(n, seed, scale=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module", params=SIZES)
def sweep(request):
    """One table size through all three implementations."""
    t_total = request.param
    scale = 4.0 if t_total <= 256 else 12.0
    v0, e1, e2, valid, rec = _random_tris(t_total, seed=t_total, scale=scale)
    o, d = _random_rays(N_RAYS, seed=1, scale=scale * 1.4)
    rng = np.random.default_rng(2)
    t_max = rng.uniform(0.5, 2.0 * scale, N_RAYS).astype(np.float32)
    t_max[::5] = 0.0  # parked lanes
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    jargs = tuple(jnp.asarray(a) for a in (v0, e1, e2, valid))
    classic = [np.asarray(x) for x in jix.intersect_triangles(jr, *jargs)]
    scene = SimpleNamespace(
        tri_v0=jargs[0], tri_e1=jargs[1], tri_e2=jargs[2],
        tri_obj=jnp.where(jargs[3], 0, -1).astype(jnp.int32),
        tri_rec=jnp.asarray(rec),
    )
    pallas = [np.asarray(x) for x in
              intersect_triangles_pallas_rec(jr, scene, interpret=True)]
    pallas_blocked = np.asarray(occluded_triangles_pallas(
        jr, *jargs, jnp.asarray(t_max), interpret=True))
    targs = tuple(_t(a) for a in (o, d, v0, e1, e2, valid))
    plain = [x.numpy() for x in kernels.sweep_nearest_rec(*targs, _t(rec))]
    plain_k2 = [x.numpy() for x in kernels.sweep_nearest(*targs)]
    plain_blocked = kernels.occluded_anyhit(*targs, _t(t_max)).numpy()
    return SimpleNamespace(
        t_total=t_total, classic=classic, pallas=pallas, plain=plain,
        plain_k2=plain_k2, pallas_blocked=pallas_blocked,
        plain_blocked=plain_blocked, t_max=t_max, rec=rec, valid=valid,
    )


def _agreeing(ref_i, got_i, ref_t, got_t):
    """Lanes to compare values on; an idx mismatch is accepted only inside
    the tie band (two hits within ~2^-17 relative t, PARITY.md
    "Nearest-hit tie-break"), as tests/test_pallas.py does."""
    mismatch = ref_i != got_i
    if mismatch.any():
        rel = np.abs(got_t[mismatch] - ref_t[mismatch]) / np.maximum(
            ref_t[mismatch], 1e-9)
        assert mismatch.sum() <= 8 and rel.max() < TIE_BAND, (
            mismatch.sum(), rel.max())
    return (ref_i >= 0) & ~mismatch


@pytest.mark.parametrize("ref_name", ["classic", "pallas"])
def test_plain_nearest_matches_jax(sweep, ref_name):
    ref = getattr(sweep, ref_name)
    pt, pi, pu, pv = sweep.plain[:4]
    ok = _agreeing(ref[1], pi, ref[0], pt)
    assert ok.sum() > min(sweep.t_total, 50) // 2  # comparison exercised hits
    np.testing.assert_allclose(pt[ok], ref[0][ok], **T_TOL)
    np.testing.assert_allclose(pu[ok], ref[2][ok], **UV_TOL)
    np.testing.assert_allclose(pv[ok], ref[3][ok], **UV_TOL)
    miss = pi < 0
    assert (pt[miss] == np.finfo(np.float32).max).all()
    assert (pu[miss] == 0).all() and (pv[miss] == 0).all()
    assert sweep.valid[pi[pi >= 0]].all()  # no padding row is ever hit


def test_plain_record_matches_pallas_and_gather(sweep):
    pi, prec = sweep.plain[1], sweep.plain[4]
    want = sweep.rec[np.maximum(pi, 0)]
    want[pi < 0] = 0.0
    np.testing.assert_array_equal(prec, want)
    same = pi == sweep.pallas[1]
    np.testing.assert_allclose(prec[same], sweep.pallas[4][same], **REC_TOL)


def test_plain_k2_equals_plain_k3(sweep):
    for a, b in zip(sweep.plain_k2, sweep.plain[:4]):
        np.testing.assert_array_equal(a, b)


def test_plain_blocked_matches_pallas(sweep):
    """The any-hit kernel compares t_s < t_max |det| on the expanded form,
    the plain version the winner's stable t: they can differ only for a hit
    within rounding of t_max, which random data does not produce."""
    np.testing.assert_array_equal(sweep.plain_blocked, sweep.pallas_blocked)
    assert not sweep.plain_blocked[sweep.t_max == 0.0].any()  # parked lanes
    assert sweep.plain_blocked.sum() > 5
    want = sweep.classic[0] < sweep.t_max
    np.testing.assert_array_equal(sweep.plain_blocked, want)


def test_classic_sweep_matches_jax(sweep):
    """The port's classic chunked Moller-Trumbore against the JAX one."""
    v0, e1, e2, valid, _ = _random_tris(
        sweep.t_total, seed=sweep.t_total,
        scale=4.0 if sweep.t_total <= 256 else 12.0)
    o, d = _random_rays(N_RAYS, seed=1,
                        scale=(4.0 if sweep.t_total <= 256 else 12.0) * 1.4)
    t, i, u, v = (x.numpy() for x in tix.intersect_triangles(
        TRays(o=_t(o), d=_t(d)), _t(v0), _t(e1), _t(e2), _t(valid)))
    ct, ci, cu, cv = sweep.classic
    np.testing.assert_array_equal(i, ci)
    hit = ci >= 0
    np.testing.assert_allclose(t[hit], ct[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u[hit], cu[hit], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(v[hit], cv[hit], rtol=1e-4, atol=1e-6)


def test_ragged_table_and_empty_inputs():
    """The Python chunk loop sweeps a ragged last chunk (600 = 512 + 88) in
    the same form; zero rays and zero triangles give empty / all-miss."""
    v0, e1, e2, valid, rec = _random_tris(600, seed=9)
    o, d = _random_rays(200, seed=10)
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    ct, ci, _, _ = (np.asarray(x) for x in jix.intersect_triangles(
        jr, *(jnp.asarray(a) for a in (
            np.pad(v0, ((0, 40), (0, 0))), np.pad(e1, ((0, 40), (0, 0))),
            np.pad(e2, ((0, 40), (0, 0))), np.pad(valid, (0, 40))))))
    t, i, u, v, r = (x.numpy() for x in kernels.sweep_nearest_rec(
        _t(o), _t(d), _t(v0), _t(e1), _t(e2), _t(valid), _t(rec)))
    ok = _agreeing(ci, i, ct, t)
    np.testing.assert_allclose(t[ok], ct[ok], **T_TOL)
    assert (i[i >= 0] >= 512).any()  # the ragged tail was swept
    e = torch.zeros((0, 3))
    out = kernels.sweep_nearest(e, e, _t(v0), _t(e1), _t(e2), _t(valid))
    assert all(x.shape == (0,) for x in out)
    none = kernels.sweep_nearest(_t(o), _t(d), e, e, e,
                                 torch.zeros((0,), dtype=torch.bool))
    assert (none[1] == -1).all()


def test_feature_matrices_match():
    v0, e1, e2, _, _ = _random_tris(64, seed=3)
    o, d = _random_rays(100, seed=4)
    np.testing.assert_allclose(
        tix._tri_features(_t(v0), _t(e1), _t(e2)).numpy(),
        np.asarray(jix._tri_features(jnp.asarray(v0), jnp.asarray(e1),
                                     jnp.asarray(e2))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tix._ray_features(_t(o), _t(d)).numpy(),
        np.asarray(jix._ray_features(jnp.asarray(o), jnp.asarray(d))),
        rtol=1e-6, atol=1e-6)


def test_tf32_is_refused(monkeypatch):
    assert not torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    v0, e1, e2, valid, _ = _random_tris(32, seed=5)
    o, d = _random_rays(4, seed=6)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tix.intersect_triangles_mm(
            TRays(o=_t(o), d=_t(d)), _t(v0), _t(e1), _t(e2), _t(valid))


def test_spheres_and_boxes_match():
    rng = np.random.default_rng(11)
    o, d = _random_rays(1000, seed=12)
    d[:10, 0] = 0.0  # axis-aligned components exercise the slab guard
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = rng.uniform(-4, 4, (6, 3)).astype(np.float32)
    r = rng.uniform(1.0, 2.5, 6).astype(np.float32)
    sv = np.array([1, 1, 0, 1, 1, 1], bool)
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    tr = TRays(o=_t(o), d=_t(d))
    jt, ji = jix.intersect_spheres(jr, jnp.asarray(c), jnp.asarray(r), jnp.asarray(sv))
    tt, ti = tix.intersect_spheres(tr, _t(c), _t(r), _t(sv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-5)
    assert (ti.numpy() >= 0).sum() > 100 and (ti.numpy() != 2).all()
    bmin = rng.uniform(-4, 0, (3, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0.5, 3, (3, 3)).astype(np.float32)
    bv = np.array([1, 0, 1], bool)
    j0, j1, jb = jix.intersect_boxes(jr, jnp.asarray(bmin), jnp.asarray(bmax), jnp.asarray(bv))
    t0, t1, tb = tix.intersect_boxes(tr, _t(bmin), _t(bmax), _t(bv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=1e-5, atol=1e-5)


def _mixed_scene():
    b = jbuilder.SceneBuilder()
    m0 = b.add_lambert((0.2, 0.4, 0.6))
    m2 = b.add_glass(1.5)
    quad = np.asarray([[[-3, -1, -3], [3, -1, -3], [3, -1, 3]],
                       [[-3, -1, -3], [3, -1, 3], [-3, -1, 3]]], np.float32)
    b.add_mesh(quad, material=m0)
    b.add_sphere((0, 0, 0), 0.8, material=m2)
    b.add_sphere_light((0, 3, 0), 0.5, (7.0, 7.0, 7.0))
    b.add_quad_light((-1, 4, -1), (1, 4, -1), (-1, 4, 1), (5.0, 5.0, 5.0))
    b.add_homogeneous_medium(0.3, 0.1, (0.2, 0.3, 0.4), (1, -1, 1), (2.5, 1, 2.5))
    return b.build()


@pytest.fixture(scope="module", params=["cornell", "mixed"])
def scene_pair(request):
    if request.param == "cornell":
        jt = jpresets.build_cornell_box().build()
        o, d = _random_rays(3000, seed=3, scale=300.0)
        o = np.abs(o) % 500.0  # inside the box, so plenty of lanes hit
    else:
        jt = _mixed_scene()
        o, d = _random_rays(3000, seed=5, scale=3.0)
    tt = convert.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()}, device="cpu")
    o = o.astype(np.float32)
    return request.param, jt, tt, o, d


def test_intersect_scene_matches_jax(scene_pair):
    name, jt, tt, o, d = scene_pair
    jh = jix.intersect_scene(jt, JRays(o=jnp.asarray(o), d=jnp.asarray(d)))
    th = tix.intersect_scene(tt, TRays(o=_t(o), d=_t(d)))
    scale = 1000.0 if name == "cornell" else 10.0
    same = np.asarray(jh.obj) == th.obj.numpy()
    assert (~same).sum() <= 3  # edge-grazing rays may flip (matmul rounding)
    assert (np.asarray(jh.obj) >= 0).sum() > 300
    for f in ("light", "medium", "mtype"):
        np.testing.assert_array_equal(
            getattr(th, f).numpy()[same], np.asarray(getattr(jh, f))[same], err_msg=f)
    # which triangle of a coplanar pair wins is a tie-band matter: compare
    # the fields that do not depend on it
    for f, tol in (("t", 1e-4 * scale), ("t1", 1e-4 * scale),
                   ("position", 1e-4 * scale), ("ng", 1e-4), ("ns", 1e-4),
                   ("dpdu", 1e-4), ("dpdv", 1e-4), ("ior", 0), ("albedo", 0)):
        a = getattr(th, f).numpy()[same]
        b = np.asarray(getattr(jh, f))[same]
        fin = np.isfinite(b) & (np.abs(b) < 1e30)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4, atol=tol, err_msg=f)
        np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=f)


def test_occluded_matches_jax(scene_pair):
    name, jt, tt, o, d = scene_pair
    t_max = np.random.default_rng(7).uniform(
        1.0, 600.0 if name == "cornell" else 8.0, o.shape[0]).astype(np.float32)
    t_max[::7] = 0.0
    jb = np.asarray(jix.occluded(
        jt, JRays(o=jnp.asarray(o), d=jnp.asarray(d)), jnp.asarray(t_max)))
    tb = tix.occluded(tt, TRays(o=_t(o), d=_t(d)), _t(t_max)).numpy()
    assert (jb != tb).sum() <= 2 and tb.sum() > 100
    assert not tb[t_max == 0.0].any()
    # emitters never block: a ray from below the quad light through it
    if name == "mixed":
        up_o = _t(np.array([[0.0, 3.8, 0.0]], np.float32))
        up_d = _t(np.array([[0.0, 1.0, 0.0]], np.float32))
        assert not bool(tix.occluded(tt, TRays(o=up_o, d=up_d),
                                     _t(np.array([10.0], np.float32)))[0])


def test_tri_fn_route_equals_default(scene_pair):
    """A given ``tri_fn`` + ``tri_rec[idx]`` is the default record sweep."""
    _, _, tt, o, d = scene_pair
    rays = TRays(o=_t(o), d=_t(d))
    a = tix.intersect_scene(tt, rays)
    b = tix.intersect_scene(tt, rays, tri_fn=kernels.sweep_nearest_tri_fn,
                            present=tix.tables_present(tt))
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    tm = torch.full((o.shape[0],), 50.0)
    assert torch.equal(
        tix.occluded(tt, rays, tm),
        tix.occluded(tt, rays, tm, tri_fn=tix.intersect_triangles_mm))
