"""The plain references against the port's own plain route on the CPU, at
sizes a test can hold: the same (seed, pixel, sample, site) draws must give
the same image to float rounding. The test imports both; the references
import nothing of the port (``test_bench_imports.py``)."""

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, port
from benchmark.reference import cloud_nee, cloud_volume, surface_gi
from tiny import tiny_config

REFERENCES = {"cornell_gi": surface_gi, "cloud_nee": cloud_nee, "cloud_volume": cloud_volume}


@pytest.mark.parametrize("name", ["cornell_gi", "cloud_nee", "cloud_volume"])
def test_reference_matches_port_plain_route(name):
    from xraytracer_tpu_torch.renderer import render

    torch.set_num_threads(2)
    cfg = tiny_config(name)
    r = cfg["render"]
    w, h, spp = r["width"], r["height"], r["spp"]
    grid = inputs.density_grid(cfg)
    tables, _, cam, integ = port.build_scene(cfg, grid, "cpu")
    seed = inputs.frame_seed(2**31 + 77, 3)
    image = render(tables, cam, integ, w, h, spp, seed=seed).image
    ref = REFERENCES[name].make(cfg, grid, "cpu")
    mean, rejected = ref.render_pixels([seed] * (w * h), np.arange(w * h), spp)
    expect = mean.numpy().reshape(h, w, 3)
    assert rejected == 0
    assert expect.mean() > 1e-3
    np.testing.assert_allclose(image, expect, rtol=1e-5, atol=1e-6)


def test_cloud_nee_reference_is_unchanged_by_the_nee_switch():
    """The NEE estimator gives, bit for bit, the image and tallies it gave
    before it had a switch (sha256 of the float64 means, on the CPU)."""
    import hashlib

    torch.set_num_threads(2)
    cfg = tiny_config("cloud_nee")
    r = cfg["render"]
    n = r["width"] * r["height"]
    ref = cloud_nee.make(cfg, inputs.density_grid(cfg), "cpu")
    mean, rejected = ref.render_pixels([inputs.frame_seed(2**31 + 77, 3)] * n,
                                       np.arange(n), r["spp"])
    assert rejected == 0
    assert ref.tally == dict(rays=361, scattered=69, sample_lanes=153, sample_segments=1735,
                             sample_candidates=275, tr_lanes=69, tr_segments=551,
                             tr_candidates=299)
    assert hashlib.sha256(mean.numpy().tobytes()).hexdigest() == (
        "adf3aee058613de9af77703007773101d27c1d8c349db58ba039be4ccab19b74")


def test_no_nee_reference_adds_le_past_depth_0():
    """The tiny cloud_volume frame is lit only by paths that reach the light
    after a scatter: the same estimator with Le at depth 0 alone and no NEE
    leaves it black."""
    torch.set_num_threads(2)
    cfg = tiny_config("cloud_volume")
    r = cfg["render"]
    n = r["width"] * r["height"]
    grid = inputs.density_grid(cfg)
    seeds, pixels = [inputs.frame_seed(2**31 + 77, 3)] * n, np.arange(n)
    mean, _ = cloud_volume.make(cfg, grid, "cpu").render_pixels(seeds, pixels, r["spp"])
    depth_0 = cloud_volume.make(cfg, grid, "cpu")
    depth_0.nee = True
    depth_0._nee = lambda rad, *a: rad
    mean_0, _ = depth_0.render_pixels(seeds, pixels, r["spp"])
    assert float(mean_0.sum()) == 0.0
    assert int((mean.sum(-1) > 0).sum()) >= 3


def test_cloud_volume_reference_refuses_nee():
    cfg = tiny_config("cloud_nee")
    with pytest.raises(ValueError):
        cloud_volume.make(cfg, inputs.density_grid(cfg), "cpu")


def test_pixel_strata_see_what_they_are_named_for():
    """The published cloud_volume frame's strata partition its pixels; the
    reference renders the pixels of ``lights`` as the light (Le where every
    sample meets it) and those of ``rest`` black."""
    import json
    import os

    torch.set_num_threads(2)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with open(os.path.join(root, "benchmark", "configs", "cloud_volume.json")) as f:
        cfg = json.load(f)
    strata = inputs.pixel_strata(cfg)
    every = np.sort(np.concatenate(list(strata.values())))
    assert np.array_equal(every, np.arange(512 * 512))
    assert all(len(v) > 1000 for v in strata.values())
    px = np.concatenate([strata["lights"][::200], strata["rest"][::10000]])
    ref = cloud_volume.make(cfg, inputs.density_grid(cfg), "cpu")
    mean, _ = ref.render_pixels([inputs.frame_seed(2**31 + 77, 0)] * len(px), px, 4)
    light = mean[:len(strata["lights"][::200])].sum(-1)
    assert bool((light > 0).all()) and int((light == 30.0).sum()) >= len(light) - 2
    assert float(mean[len(light):].abs().sum()) == 0.0


def test_frame_pixels_draw_from_each_stratum():
    """``check.strata``: that many distinct pixels of each stratum, the same
    for the same (seed, frame); without it, the draw over the whole frame."""
    cfg = tiny_config("cloud_volume")
    cfg["render"].update(width=48, height=48)
    cfg["scene"]["sphere_lights"][0].update(center=[0.0, 380.0, 0.0], radius=50.0)
    cfg["check"]["strata"] = {"media": 5, "lights": 3, "rest": 2}
    strata = inputs.pixel_strata(cfg)
    px = inputs.frame_pixels(cfg, strata, 2**40 + 3, 7)
    assert len(set(px.tolist())) == 10 and np.all(np.diff(px) > 0)
    for name, k in cfg["check"]["strata"].items():
        assert np.isin(px, strata[name]).sum() == k
    assert np.array_equal(px, inputs.frame_pixels(cfg, strata, 2**40 + 3, 7))
    plain = tiny_config("cloud_nee")
    n = plain["render"]["width"] * plain["render"]["height"]
    assert np.array_equal(inputs.frame_pixels(plain, None, 2**40 + 3, 7),
                          inputs.checked_pixels(2**40 + 3, 7, n, plain["check"]["pixels_per_frame"]))


def test_cloud_derived_tables_match_the_port():
    """The supergrid, majorant and step bound the reference works out from
    the grid equal the port's tables."""
    from xraytracer_tpu_torch.media import default_max_steps

    cfg = tiny_config("cloud_nee")
    grid = inputs.density_grid(cfg)
    tables, _, _, _ = port.build_scene(cfg, grid, "cpu")
    nb, bs, sg = cloud_nee.supergrid(grid)
    np.testing.assert_array_equal(nb, tables.grid_super_nb.numpy())
    np.testing.assert_array_equal(bs, tables.grid_super_bsize.numpy())
    np.testing.assert_array_equal(sg.reshape(-1), tables.grid_super.numpy())
    spec, med = cfg["scene"]["density_grid"], cfg["scene"]["media"][0]
    majorant, max_steps = cloud_nee.medium_constants(
        grid, spec["bmin"], spec["bmax"], med["absorption"], med["scattering"])
    assert majorant == tables.med_majorant.numpy()[0]
    assert max_steps == default_max_steps(tables)


def test_cornell_triangles_match_the_port():
    cfg = tiny_config("cornell_gi")
    tables, _, _, _ = port.build_scene(cfg, None, "cpu")
    a = surface_gi.scene_arrays(cfg["scene"])
    t = a["v0"].shape[0]
    assert int((tables.tri_obj >= 0).sum()) == t
    np.testing.assert_array_equal(tables.tri_v0.numpy()[:t], a["v0"])
    np.testing.assert_array_equal(tables.tri_e1.numpy()[:t], a["e1"])
    np.testing.assert_array_equal(tables.tri_e2.numpy()[:t], a["e2"])


def test_procedural_cloud_is_the_repositorys():
    from xraytracer_tpu_torch.scene.presets import procedural_cloud

    np.testing.assert_array_equal(inputs.procedural_cloud((64, 64, 64), 0),
                                  procedural_cloud((64, 64, 64), 0))


def test_adam_step_from_a_state_is_the_loops_update():
    """``cloud_grad.adam_step`` written out equals ``torch.optim.Adam`` with
    the loop's clipping, from the same state and gradient."""
    from types import SimpleNamespace

    from benchmark.reference import cloud_grad

    gen = torch.Generator().manual_seed(5)
    shape = (4, 5, 6)
    true = torch.rand(shape, generator=gen) + 0.5
    g = torch.randn(shape, generator=gen) * 3.0        # clipped: its norm is > 1
    z = torch.randn(shape, generator=gen)
    m = torch.randn(shape, generator=gen) * 1e-2
    v = torch.rand(shape, generator=gen) * 1e-3
    stub = SimpleNamespace(dev=torch.device("cpu"), dt=torch.float32, true=true,
                           value_and_grad=lambda dens, *a: (torch.tensor(0.0), g, None, None))
    state = {"z": z.numpy(), "exp_avg": m.numpy(), "exp_avg_sq": v.numpy(),
             "step": 41.0, "lr": 0.037}
    *_, z_ref = cloud_grad.adam_step(stub, state, None, 0, 0, 1, max_norm=1.0)

    zt = z.clone().requires_grad_(True)
    opt = torch.optim.Adam([zt], lr=0.037)
    opt.state[zt] = {"step": torch.tensor(41.0), "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
    s = torch.sigmoid(zt.detach())
    zt.grad = g * true * (s * (1.0 - s))
    torch.nn.utils.clip_grad_norm_([zt], 1.0)
    opt.step()
    torch.testing.assert_close(z_ref, zt.detach(), rtol=1e-5, atol=1e-7)
    assert float((zt.detach() - z).abs().max()) > 1e-3
