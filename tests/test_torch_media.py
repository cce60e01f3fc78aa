"""Port parity, participating media: ``xraytracer_tpu_torch/media.py`` and
``media_kernels.py`` against the JAX package's ``media.py`` (its XLA path,
``het_fn=None``) and, one case per kernel, against its Pallas tracking
kernels in interpret mode.

Inputs are made with numpy from seeds and handed to both packages; the
port's tables are the JAX tables carried across by
``convert.tables_from_numpy``. Everything runs on CPU tensors, where the
kernel wrappers take their plain versions; the CUDA kernels are held against
these same plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xraytracer_tpu import media as jmedia
from xraytracer_tpu import media_pallas as jmp
from xraytracer_tpu.geometry import Rays as JRays
from xraytracer_tpu.sampling import path_keys as j_path_keys
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu_torch import convert, media
from xraytracer_tpu_torch import media_kernels as mkk
from xraytracer_tpu_torch.geometry import Rays
from xraytracer_tpu_torch.sampling import rng
from xraytracer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

N = 1024
MAX_STEPS = 96
# The gates of tests/test_het_kernel.py: both sides draw the same numbers and
# make the same decisions; positions differ by float32 rounding of o + t * d
# at coordinates of a few hundred units (atol 1e-4), weights by the order of
# a handful of float32 products and by exp / log of two math libraries
POS = dict(rtol=1e-5, atol=1e-4)
WEIGHT = dict(rtol=1e-4, atol=1e-6)
DIR = dict(rtol=1e-5, atol=1e-6)


def _to_port(jt):
    return convert.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()}, device="cpu")


@pytest.fixture(scope="module")
def scene():
    # the scene of tests/test_het_kernel.py: a bf16-exact grid, so that the
    # Pallas kernels (which sample the bf16-rounded field) see the same field
    density = np.asarray(jmp.round_bf16(
        jpresets.procedural_cloud(res=(24, 20, 16), seed=3)))
    jt = jpresets.build_volume_scene(
        density=density, scattering=(0.9, 0.7, 0.5), absorption=(0.3, 0.2, 0.1)
    ).build()
    return jt, _to_port(jt)


@pytest.fixture(scope="module")
def lanes():
    """The wavefront of tests/test_het_kernel.py at N = 1024, as numpy."""
    g = np.random.default_rng(11)
    o = g.normal(size=(N, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 500.0
    target = g.normal(scale=80.0, size=(N, 3)).astype(np.float32)
    target[: N // 8] += 2000.0          # these lanes miss the grid
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t0 = g.uniform(200.0, 320.0, N).astype(np.float32)
    t1 = t0 + g.uniform(0.0, 400.0, N).astype(np.float32)
    tp = g.uniform(0.2, 1.0, (N, 3)).astype(np.float32)
    het_mask = g.uniform(size=N) > 0.0625   # ~1/16 lanes pass through
    return dict(o=o.astype(np.float32), d=d, t0=t0, t1=t1, tp=tp, mask=het_mask)


def _jax_lanes(L, n=None):
    n = n or L["o"].shape[0]
    rays = JRays(o=jnp.asarray(L["o"][:n]), d=jnp.asarray(L["d"][:n]))
    keys = j_path_keys(7, jnp.arange(n, dtype=jnp.int32), 0)
    return (rays, jnp.asarray(L["t0"][:n]), jnp.asarray(L["t1"][:n]),
            jnp.asarray(L["tp"][:n]), keys, jnp.asarray(L["mask"][:n]))


def _port_lanes(L, n=None):
    n = n or L["o"].shape[0]
    T = torch.from_numpy
    rays = Rays(o=T(L["o"][:n]), d=T(L["d"][:n]))
    keys = rng.path_keys(7, torch.arange(n), 0)
    return (rays, T(L["t0"][:n]), T(L["t1"][:n]), T(L["tp"][:n]), keys,
            T(L["mask"][:n]))


def _check_sample(got, want):
    np.testing.assert_array_equal(got.scattered.numpy(), np.asarray(want.scattered))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), **POS)
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight), **WEIGHT)
    np.testing.assert_allclose(got.dir.numpy(), np.asarray(want.dir), **DIR)


def test_medium_and_grid_tables_cross_exactly(scene):
    """Every ``med_*`` / ``grid_*`` field carried across by
    ``tables_from_numpy`` equals what the port's own builder makes."""
    jt, tt = scene
    own = tpresets.build_volume_scene(
        density=np.asarray(jt.grid_density), scattering=(0.9, 0.7, 0.5),
        absorption=(0.3, 0.2, 0.1)).build(device="cpu")
    fields = [f for f in tt._fields if f.startswith(("med_", "grid_", "box_"))]
    assert len(fields) >= 15
    for f in fields:
        a, b = getattr(tt, f), getattr(own, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jt, f)), err_msg=f)


@pytest.mark.parametrize("variant", ["mis", "achromatic", "nomis"])
def test_sample_homogeneous(variant, lanes):
    jt = jpresets.build_vpt_scene(variant).build()
    tt = _to_port(jt)
    jr, jt0, jt1, jtp, jk, _ = _jax_lanes(lanes)
    tr, tt0, tt1, ttp, tk, _ = _port_lanes(lanes)
    jmed = jmedia.gather_medium(jt, jnp.zeros((N,), jnp.int32))
    tmed = media.gather_medium(tt, torch.zeros((N,), dtype=torch.int32))
    for k in jmed:
        np.testing.assert_array_equal(tmed[k].numpy(), np.asarray(jmed[k]))
    # spans of about one mean free path, so that lanes scatter and escape
    jt1s, tt1s = jt0 + (jt1 - jt0) * 0.005, tt0 + (tt1 - tt0) * 0.005
    want = jmedia._sample_homogeneous(jmed, jr, jt0, jt1s, jtp, jk, 16)
    got = media._sample_homogeneous(tmed, tr, tt0, tt1s, ttp, tk, 16)
    _check_sample(got, want)
    assert 0.05 < float(got.scattered.float().mean()) < 0.95


@pytest.mark.parametrize("where", ["inside", "faces", "outside"])
@pytest.mark.parametrize("use_packed", [True, False])
def test_density_lookup(scene, where, use_packed):
    jt, tt = scene
    g = np.random.default_rng(5)
    lo, hi = np.asarray(jt.grid_min), np.asarray(jt.grid_max)
    p = g.uniform(lo, hi, (2048, 3)).astype(np.float32)
    if where == "faces":
        # exactly on a bound, on a voxel centre, and on the far corner
        p[::3, 0] = lo[0]
        p[1::3, 1] = hi[1]
        p[2::3, 2] = lo[2] + (hi[2] - lo[2]) * 7.0 / 15.0
        p[-1] = hi
    elif where == "outside":
        p[::2] += (hi - lo) * 1.01
    want = np.asarray(jmedia.density_lookup(jt, jnp.asarray(p), use_packed=use_packed))
    got = media.density_lookup(tt, torch.from_numpy(p), use_packed=use_packed).numpy()
    # eight products summed in two orders: a few ulp of a density <= 1
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if where == "outside":
        assert (got[::2] == 0).all()
    else:
        assert (got > 0).mean() > 0.1


def test_majorant_segments(scene, lanes):
    """The block SEQUENCE (which majorant each segment carries) must agree
    exactly; times and optical depths to float32 rounding."""
    jt, tt = scene
    jr, jt0, jt1, _, _, _ = _jax_lanes(lanes)
    tr, tt0, tt1, _, _, _ = _port_lanes(lanes)
    jmed = jmedia.gather_medium(jt, jnp.zeros((N,), jnp.int32))
    tmed = media.gather_medium(tt, torch.zeros((N,), dtype=torch.int32))
    want = jmedia._majorant_segments(jt, jmed, jr, jt0, jt1)
    got = media._majorant_segments(tt, tmed, tr, tt0, tt1)
    assert got[0].shape == (N, 25) and got[2].shape == (N, 26)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-5)
    tau = torch.from_numpy(
        np.random.default_rng(2).uniform(0, 8, N).astype(np.float32))
    jt_, jm = jmedia._tau_to_t(*want, jnp.asarray(tau.numpy()))
    tt_, tm = media._tau_to_t(*got, tau)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tt_.numpy(), np.asarray(jt_), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("chan_uniform", [False, True])
def test_sample_medium_heterogeneous(scene, lanes, chan_uniform):
    jt, tt = scene
    jr, jt0, jt1, jtp, jk, jm = _jax_lanes(lanes)
    tr, tt0, tt1, ttp, tk, tm = _port_lanes(lanes)
    kw = dict(max_steps=MAX_STEPS, has_heterogeneous=True,
              has_homogeneous=False, chan_uniform=chan_uniform)
    want = jmedia.sample_medium(jt, jnp.where(jm, 0, -1), jr, jt0, jt1, jtp,
                                jk, 16, **kw)
    neg1 = torch.full((N,), -1, dtype=torch.int32)
    med_idx = torch.where(tm, torch.zeros_like(neg1), neg1)
    got = media.sample_medium(tt, med_idx, tr, tt0, tt1, ttp, tk, 16, **kw)
    _check_sample(got, want)
    scat = (got.scattered & tm).float().mean()
    assert 0.02 < float(scat) < 0.98
    # the kernel's wrapper on CPU tensors: its plain version, the same result
    het_fn = mkk.try_make_fused_het_sampler(tt, MAX_STEPS, force=True,
                                            chan_uniform=chan_uniform)
    mkk.reset_counts()
    via = media.sample_medium(tt, med_idx, tr, tt0, tt1, ttp, tk, 16,
                              het_fn=het_fn, **kw)
    assert mkk.counts()["track_sample"] == {"launches": 0, "plain_calls": 1}
    for a, b in zip(via, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # masked lanes pass through untouched
    off = ~tm.numpy()
    assert (via.weight.numpy()[off] == 1).all() and not via.scattered.numpy()[off].any()


def test_segment_transmittance(scene, lanes):
    jt, tt = scene
    jr, jt0, jt1, _, jk, jm = _jax_lanes(lanes)
    tr, tt0, tt1, _, tk, tm = _port_lanes(lanes)
    site = 8192 + 16
    want = np.asarray(jmedia.segment_transmittance(
        jt, jnp.where(jm, 0, -1), jr.at(jt0), jr.at(jt1), jk, site,
        max_steps=MAX_STEPS))
    neg1 = torch.full((N,), -1, dtype=torch.int32)
    med_idx = torch.where(tm, torch.zeros_like(neg1), neg1)
    got = media.segment_transmittance(
        tt, med_idx, tr.at(tt0), tr.at(tt1), tk, site, max_steps=MAX_STEPS)
    np.testing.assert_allclose(got.numpy(), want, **WEIGHT)
    r = got.numpy()[tm.numpy()]
    assert (r > 0).any() and (r < 1).any() and (got.numpy()[~tm.numpy()] == 1).all()
    het_tr_fn = mkk.try_make_fused_het_transmittance(tt, MAX_STEPS, force=True)
    mkk.reset_counts()
    via = media.segment_transmittance(
        tt, med_idx, tr.at(tt0), tr.at(tt1), tk, site, max_steps=MAX_STEPS,
        het_tr_fn=het_tr_fn)
    assert mkk.counts()["track_transmittance"] == {"launches": 0, "plain_calls": 1}
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def test_delta_tracking_transmittance(scene, lanes):
    jt, tt = scene
    n = 256
    jr, jt0, jt1, _, jk, jm = _jax_lanes(lanes, n)
    tr, tt0, tt1, _, tk, tm = _port_lanes(lanes, n)
    want = np.asarray(jmedia.delta_tracking_transmittance(
        jt, jnp.where(jm, 0, -1), jr.at(jt0), jr.at(jt1), jk, 40, max_steps=64))
    neg1 = torch.full((n,), -1, dtype=torch.int32)
    got = media.delta_tracking_transmittance(
        tt, torch.where(tm, torch.zeros_like(neg1), neg1), tr.at(tt0),
        tr.at(tt1), tk, 40, max_steps=64).numpy()
    # a binary estimator: a lane is 0 or a ratio of null-collision rates
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, **WEIGHT)


@pytest.mark.parametrize("kernel", ["track_sample", "track_transmittance"])
def test_plain_version_matches_pallas_kernel(scene, lanes, kernel):
    """One case per kernel against the TPU kernel itself, in interpret mode
    on the bf16-exact grid (the rest of this file goes through the JAX
    package's XLA path, which its own tests tie to the kernels)."""
    jt, tt = scene
    n, steps = 256, 16
    jr, jt0, jt1, jtp, jk, jm = _jax_lanes(lanes, n)
    tr, tt0, tt1, ttp, tk, tm = _port_lanes(lanes, n)
    if kernel == "track_sample":
        jf = jmp.try_make_fused_het_sampler(jt, steps, interpret=True, force=True)
        tf = mkk.try_make_fused_het_sampler(tt, steps, force=True)
        assert jf is not None and tf is not None
        want = jf(jr, jt0, jt1, jtp, jk, 16, jm)
        got = tf(tr, tt0, tt1, ttp, tk, 16, tm)
        on = tm.numpy()
        np.testing.assert_array_equal(got.scattered.numpy(), np.asarray(want.scattered))
        np.testing.assert_allclose(got.pos.numpy()[on], np.asarray(want.pos)[on], **POS)
        np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight), **WEIGHT)
        np.testing.assert_allclose(got.dir.numpy(), np.asarray(want.dir), **DIR)
        # some lanes run out of steps at this bound: weight 0 on both sides
        assert (got.weight.numpy() == 0).all(axis=-1).any()
    else:
        jf = jmp.try_make_fused_het_transmittance(jt, steps, interpret=True, force=True)
        tf = mkk.try_make_fused_het_transmittance(tt, steps, force=True)
        want = np.asarray(jf(jr.at(jt0), jr.at(jt1), jk, 8208, jm))
        got = tf(tr.at(tt0), tr.at(tt1), tk, 8208, tm).numpy()
        np.testing.assert_allclose(got, want, **WEIGHT)
        assert (got[~tm.numpy()] == 1).all()


def test_eval_phase_and_default_max_steps(scene):
    jt, tt = scene
    g = np.random.default_rng(1)
    wo = g.normal(size=(64, 3)).astype(np.float32)
    wi = g.normal(size=(64, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    want = np.asarray(jmedia.eval_phase(
        jt, jnp.zeros((64,), jnp.int32), jnp.asarray(wo), jnp.asarray(wi)))
    got = media.eval_phase(tt, torch.zeros((64,), dtype=torch.int32),
                           torch.from_numpy(wo), torch.from_numpy(wi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert media.default_max_steps(tt) == jmedia.default_max_steps(jt)
    for name in ("vpt", "nee", "volume"):
        jtab = getattr(jpresets, f"preset_{name}")()[0]
        ttab = getattr(tpresets, f"preset_{name}")(device="cpu")[0]
        assert media.default_max_steps(ttab) == jmedia.default_max_steps(jtab), name
    assert media.SITES_PER_STEP == jmedia.SITES_PER_STEP


def test_gradient_options_wait_for_their_slice(scene, lanes):
    _, tt = scene
    tr, tt0, tt1, ttp, tk, tm = _port_lanes(lanes, 8)
    idx = torch.zeros((8,), dtype=torch.int32)
    for kw in (dict(differentiable=True), dict(score_terms=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            media.sample_medium(tt, idx, tr, tt0, tt1, ttp, tk, 16, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        media.segment_transmittance(tt, idx, tr.at(tt0), tr.at(tt1), tk, 16,
                                    differentiable=True)


def test_kernel_factories_and_input_checks(scene):
    """Routing: CPU tables need ``force``; a scene without a heterogeneous
    medium has no tracking kernels; a site must be a host integer."""
    _, tt = scene
    assert mkk.try_make_fused_het_sampler(tt, 64) is None
    assert mkk.try_make_fused_het_transmittance(tt, 64) is None
    vpt = tpresets.preset_vpt(device="cpu")[0]
    assert mkk.try_make_fused_het_sampler(vpt, 64, force=True) is None
    hm = mkk.het_medium(tt, 64)
    assert hm.row == 0 and hm.max_steps == 64 and len(hm.fc) == 33 and len(hm.ic) == 9
    res = [float(s - 1) for s in tt.grid_density.shape]
    assert list(hm.fc[9:12]) == res and list(hm.ic[:3]) == list(tt.grid_density.shape)
    z = torch.zeros((4, 3))
    with pytest.raises(TypeError, match="site"):
        mkk.track_sample_plain(hm, z, z, z[:, 0], z[:, 0], z,
                               torch.zeros(4, dtype=torch.int64),
                               torch.tensor(3), torch.ones(4, dtype=torch.bool))
