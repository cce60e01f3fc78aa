"""Port parity, the volume integrators: ``make_volume_integrator`` of the
port against the JAX package's on the ``vpt`` scene (homogeneous box) and
against the committed cloud golden (heterogeneous medium with NEE), plus
counters, checkpoint resume and the CLI.

Everything runs on CPU tensors: the wavefront loop with the host-side
tracking loops, or (``force`` through ``media_kernels``) the tracking
kernels' plain versions. The card's routes are driven by ``chip_smoke.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xraytracer_tpu.geometry import Rays as JRays
from xraytracer_tpu.integrators import volume as jvolume
from xraytracer_tpu.sampling import path_keys as j_path_keys
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu_torch import cli, convert, media_kernels as mkk
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.geometry import Rays
from xraytracer_tpu_torch.integrators import make_volume_integrator, volume
from xraytracer_tpu_torch.math import from_rows
from xraytracer_tpu_torch.renderer import Accumulator, WavefrontRenderer, render
from xraytracer_tpu_torch.sampling import rng
from xraytracer_tpu_torch.scene import builder as tbuilder
from xraytracer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

W, H = 24, 18
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "cloud_nee_24x18_4spp_seed0.npy")


def _bf16_exact(a):
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


@pytest.fixture(scope="module")
def vpt():
    jt = jpresets.build_vpt_scene().build()
    tt = convert.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()}, device="cpu")
    return (jt, jbuilder.scene_statics(jt)), (tt, tbuilder.scene_statics(tt))


@pytest.fixture(scope="module")
def camera_rays():
    """W x H rays from the vpt camera position through the box and past it,
    and the keys of ``path_keys(5, arange(n), 0)``, as numpy."""
    n = W * H
    g = np.random.default_rng(11)
    o = np.tile(np.array([0.0, 0.0, 5.0], np.float32), (n, 1))
    d = np.stack([g.uniform(-0.3, 0.3, n), g.uniform(-0.3, 0.3, n),
                  -np.ones(n)], axis=-1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _cloud(device="cpu"):
    """The scene, camera and options of the cloud golden
    (tests/test_golden.py::_volume_nee_render)."""
    density = _bf16_exact(tpresets.procedural_cloud(res=(24, 20, 16), seed=3))
    tables = tpresets.build_volume_scene(
        density=density, absorption=(0.02, 0.02, 0.02),
        scattering=(0.06, 0.05, 0.04), le=30.0).build(device)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 70.0, 550.0, 1)
    cam = PinholeCamera.make(W / H, c2w=c2w, fov_deg=60.0, device=device)
    return tables, tbuilder.scene_statics(tables), cam


@pytest.mark.parametrize("nee", [False, True], ids=["vpt", "vpt_nee"])
def test_integrate_matches_jax_with_counters(vpt, camera_rays, nee):
    """Radiance and all five per-iteration counters on the vpt scene."""
    (jt, jst), (tt, tst) = vpt
    o, d = camera_rays
    n = o.shape[0]
    ji = jvolume.make_volume_integrator(jt, jst, 3, nee=nee, fused="never",
                                        with_stats=True)
    jrad, jstats = ji(JRays(o=jnp.asarray(o), d=jnp.asarray(d)),
                      j_path_keys(5, jnp.arange(n, dtype=jnp.uint32), 0))
    ti = make_volume_integrator(tt, tst, 3, nee=nee, with_stats=True)
    keys = rng.path_keys(5, torch.arange(n), 0)
    rays = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    trad, tstats = ti(rays, keys)
    # same draws and decisions; what differs is exp / log / sin / cos of two
    # math libraries and the order of a few products: a few ulp of O(1)
    np.testing.assert_allclose(trad.numpy(), np.asarray(jrad), rtol=2e-5, atol=2e-6)
    assert set(tstats) == set(jstats) == set(volume.STAT_KEYS)
    for k in volume.STAT_KEYS:
        assert tstats[k].shape == (8,) and tstats[k].dtype == torch.int32
        np.testing.assert_array_equal(tstats[k].numpy(), np.asarray(jstats[k]), err_msg=k)
    assert int(tstats["scattered"].sum()) > n // 4 and trad.numpy().mean() > 1e-3
    # without counters the same radiance, and no fused route on CPU tables
    plain = make_volume_integrator(tt, tst, 3, nee=nee)
    assert not hasattr(plain, "fused_spec")
    np.testing.assert_array_equal(plain(rays, keys).numpy(), trad.numpy())


def test_grad_sampling_matches_jax(vpt, camera_rays):
    """Roulette off and (for heterogeneous media) a uniform channel pick."""
    (jt, jst), (tt, tst) = vpt
    o, d = camera_rays
    n = o.shape[0]
    ji = jvolume.make_volume_integrator(jt, jst, 3, nee=True, fused="never",
                                        grad_sampling=True, with_stats=True)
    jrad, jstats = ji(JRays(o=jnp.asarray(o), d=jnp.asarray(d)),
                      j_path_keys(5, jnp.arange(n, dtype=jnp.uint32), 0))
    ti = make_volume_integrator(tt, tst, 3, nee=True, grad_sampling=True,
                                with_stats=True)
    trad, tstats = ti(Rays(o=torch.from_numpy(o), d=torch.from_numpy(d)),
                      rng.path_keys(5, torch.arange(n), 0))
    np.testing.assert_allclose(trad.numpy(), np.asarray(jrad), rtol=2e-5, atol=2e-6)
    assert int(tstats["rr_killed"].sum()) == 0 == int(np.asarray(jstats["rr_killed"]).sum())
    np.testing.assert_array_equal(tstats["scattered"].numpy(), np.asarray(jstats["scattered"]))


@pytest.mark.parametrize("route", ["host_loops", "kernel_wrappers"])
def test_cloud_nee_matches_golden(route, monkeypatch):
    """The heterogeneous NEE golden of tests/test_golden.py at its own gate
    (rtol 1e-5, atol 1e-7): supergrid DDA, delta tracking, ratio-tracked
    shadow transmittance, sphere-light NEE. ``kernel_wrappers`` takes the
    route the card takes (``het_fn`` / ``het_tr_fn`` of ``media_kernels``),
    whose wrappers run their plain versions on CPU tensors."""
    tables, st, cam = _cloud()
    if route == "kernel_wrappers":
        for name in ("try_make_fused_het_sampler", "try_make_fused_het_transmittance"):
            orig = getattr(mkk, name)
            monkeypatch.setattr(
                mkk, name, lambda *a, _o=orig, **k: _o(*a, force=True, **k))
    mkk.reset_counts()
    integ = make_volume_integrator(tables, st, 8, nee=True, max_steps=96)
    r = render(tables, cam, integ, W, H, 4, seed=0)
    expect = np.load(GOLDEN)
    assert r.n_rejected == 0
    np.testing.assert_allclose(r.image, expect, rtol=1e-5, atol=1e-7)
    calls = mkk.counts()
    want = 4 * 18 if route == "kernel_wrappers" else 0   # spp x iterations
    assert calls["track_sample"] == {"launches": 0, "plain_calls": want}
    assert calls["track_transmittance"] == {"launches": 0, "plain_calls": want}


def test_cloud_counters_and_checkpoint_resume(tmp_path):
    """``with_stats`` through the renderer, and a render resumed from a
    checkpoint is bitwise the uninterrupted one."""
    tables, st, cam = _cloud()
    integ = make_volume_integrator(tables, st, 4, nee=True, max_steps=64,
                                   with_stats=True)
    r = WavefrontRenderer(tables, cam, integ, W, H, seed=3)
    whole = r.render(3)
    assert set(whole.stats) == set(volume.STAT_KEYS)
    rays = whole.stats["rays"]
    assert rays.shape == (10,) and rays[0] == 3 * W * H and (np.diff(rays) <= 0).all()
    assert whole.total_rays == int(rays.sum()) and whole.stats["scattered"].sum() > 0
    ck = str(tmp_path / "ck.npz")
    r.render(2, spp_chunk=1, checkpoint_path=ck)
    resumed = r.render(3, accumulator=Accumulator.load(ck, device="cpu"))
    np.testing.assert_array_equal(resumed.image, whole.image)


@pytest.mark.parametrize("max_steps", [64, 96, 2044, 2045, 4096, 13000])
def test_nee_site_layout(max_steps):
    assert volume._nee_site_layout(max_steps) == jvolume._nee_site_layout(max_steps)
    with pytest.raises(ValueError, match="site budget"):
        volume._nee_site_layout(13200)


def test_gradient_options_raise(vpt):
    _, (tt, tst) = vpt
    for kw in (dict(differentiable=True), dict(score_terms=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_volume_integrator(tt, tst, 3, **kw)


@pytest.mark.parametrize("preset,extra", [
    ("vpt", []), ("vpt", ["--integrator", "vpt_nee", "--stats"]),
    ("nee", ["--max-steps", "48"]), ("volume", ["--max-depth", "2"]),
])
def test_cli_renders_the_volume_presets(preset, extra, tmp_path, capsys):
    out = str(tmp_path / "o.png")
    args = ["--preset", preset, "--width", "12", "--height", "9", "--spp", "1",
            "--device", "cpu", "-o", out] + extra
    if "--max-depth" not in extra:
        args += ["--max-depth", "3"]
    assert cli.main(args) == 0
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    text = capsys.readouterr().out
    assert f"preset={preset}" in text
    if "--stats" in extra:
        assert "scattered=" in text and "emitter_hits=" in text
