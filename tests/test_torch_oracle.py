"""The port's integrators against the framework-independent numpy oracles.

``tests/test_oracle.py`` and ``tests/test_oracle_volume.py`` hold the JAX
package's renders against scalar re-implementations written from the math
(their own PCG, camera, intersection, light sampling, shading and tracking),
at the same (seed, pixel, sample, site) draws. Here the same oracles, fed
the port's CPU tables, hold the port's wavefront renders, at each oracle's
own frame size, sample count and tolerance:

* ``Oracle``: the direct integrator (NEE over the quad light, 0.18 on a
  miss) on the Cornell box, 16x12, 2 spp, rtol 5e-4 / atol 5e-5, and the
  normal integrator, 1 spp, atol 1e-4;
* ``GIOracle``: GI at depth 2 (NEE, roulette, cosine bounce) and the
  indirect integrator at depth 3 on the Cornell box, 16x12, 2 spp,
  rtol 1e-3 / atol 2e-4;
* ``WhittedOracle``: Whitted at depth 3 (mirror, Fresnel glass, point and
  distant light, sky) on ``test_oracle.py``'s pane scene
  (``chip_smoke.pane_scene``), 16x12, 2 spp, rtol 1e-3 / atol 2e-4;
* ``VPTOracle``: the achromatic homogeneous box without NEE at depth 3,
  16x12, 2 spp, rtol 1e-3 / atol 2e-4;
* ``HetVolumeOracle`` / ``HetVolumeNEEOracle``: a 5^3 cloud under a sphere
  light (supergrid delta tracking, spectral MIS, phase resampling; with NEE
  the cone sample and the ratio-tracked transmittance), depth 3,
  ``max_steps`` 64, 12x9, 3 spp, rtol 2e-3 / atol 3e-4.

Only the oracle classes come from the JAX tests; the scenes are built by the
port's own builder and rendered on CPU tensors.
"""

import numpy as np
import torch

from chip_smoke import pane_scene
from test_oracle import GIOracle, Oracle, VPTOracle, WhittedOracle
from test_oracle import H as OH, SPP as OSPP, W as OW
from test_oracle_volume import H as VH, SPP as VSPP, W as VW
from test_oracle_volume import HetVolumeNEEOracle, HetVolumeOracle
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.integrators import (
    make_direct_integrator,
    make_normal_integrator,
    make_path_integrator,
    make_volume_integrator,
    make_whitted_integrator,
)
from xraytracer_tpu_torch.math import from_rows
from xraytracer_tpu_torch.renderer import render
from xraytracer_tpu_torch.scene.builder import SceneBuilder, scene_statics
from xraytracer_tpu_torch.scene.presets import (
    build_cornell_box, build_vpt_scene, cornell_camera)

torch.set_num_threads(1)


def _expect(fn, w, h, spp):
    out = np.zeros((h, w, 3))
    for py in range(h):
        for px in range(w):
            for s in range(spp):
                out[py, px] += fn(px, py, s)
    return out / spp


def test_direct_matches_oracle():
    """The port of ``test_oracle.py::test_direct_matches_oracle``."""
    tables = build_cornell_box().build("cpu")
    camk = cornell_camera()
    cam = PinholeCamera.make(OW / OH, device="cpu", **camk)
    integ = make_direct_integrator(tables, scene_statics(tables))
    image = render(tables, cam, integ, OW, OH, OSPP, seed=0).image
    oracle = Oracle(tables, camk, OW, OH, seed=0)
    expect = _expect(oracle.direct, OW, OH, OSPP)
    np.testing.assert_allclose(image, expect, rtol=5e-4, atol=5e-5)


def test_normal_matches_oracle():
    """The port of ``test_oracle.py::test_normal_matches_oracle``."""
    tables = build_cornell_box().build("cpu")
    camk = cornell_camera()
    cam = PinholeCamera.make(OW / OH, device="cpu", **camk)
    image = render(tables, cam, make_normal_integrator(tables), OW, OH, 1,
                   seed=0).image
    oracle = Oracle(tables, camk, OW, OH, seed=0)
    expect = _expect(oracle.normal_viz, OW, OH, 1)
    np.testing.assert_allclose(image, expect, atol=1e-4)


def test_whitted_matches_oracle():
    """The port of ``test_oracle.py::test_whitted_matches_oracle``: mirror,
    glass, delta-light NEE and sky."""
    tables, camk = pane_scene("cpu")
    cam = PinholeCamera.make(OW / OH, device="cpu", **camk)
    integ = make_whitted_integrator(tables, scene_statics(tables), max_depth=3)
    image = render(tables, cam, integ, OW, OH, OSPP, seed=0).image
    oracle = WhittedOracle(tables, camk, OW, OH, seed=0)
    expect = _expect(oracle.whitted, OW, OH, OSPP)
    np.testing.assert_allclose(image, expect, rtol=1e-3, atol=2e-4)
    # the scene must actually exercise all three materials
    assert expect.mean() > 0.01


def _cornell_render(max_depth, nee):
    tables = build_cornell_box().build("cpu")
    camk = cornell_camera()
    cam = PinholeCamera.make(OW / OH, device="cpu", **camk)
    integ = make_path_integrator(tables, scene_statics(tables), max_depth, nee=nee,
                                 cosine_sampling=True)
    return tables, camk, render(tables, cam, integ, OW, OH, OSPP, seed=0).image


def test_gi_depth2_matches_oracle():
    """Depth-2 GI on the Cornell box (the port of
    ``test_oracle.py::test_gi_depth2_matches_oracle``)."""
    tables, camk, image = _cornell_render(2, True)
    oracle = GIOracle(tables, camk, OW, OH, seed=0)
    expect = _expect(oracle.gi, OW, OH, OSPP)
    np.testing.assert_allclose(image, expect, rtol=1e-3, atol=2e-4)
    assert expect.mean() > 1e-3


def test_indirect_depth3_matches_oracle():
    """The BSDF-only integrator (Le at every depth) at depth 3 (the port of
    ``test_oracle.py::test_indirect_depth3_matches_oracle``)."""
    tables, camk, image = _cornell_render(3, False)
    oracle = GIOracle(tables, camk, OW, OH, seed=0)
    expect = _expect(lambda px, py, s: oracle.gi(px, py, s, max_depth=3, nee=False),
                     OW, OH, OSPP)
    np.testing.assert_allclose(image, expect, rtol=1e-3, atol=2e-4)
    assert expect.mean() > 1e-3


def test_vpt_matches_oracle():
    """The achromatic homogeneous box, no NEE, depth 3 (the port of
    ``test_oracle.py::test_vpt_matches_oracle``)."""
    tables = build_vpt_scene(variant="achromatic").build("cpu")
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 5.0, 1)
    fov = 2.0 * 180.0 * np.arctan(1.0 / 3.0) / np.pi
    camk = dict(c2w=c2w, fov_deg=fov)
    cam = PinholeCamera.make(OW / OH, device="cpu", **camk)
    integ = make_volume_integrator(tables, scene_statics(tables), 3, nee=False,
                                   max_steps=16)
    image = render(tables, cam, integ, OW, OH, OSPP, seed=0).image
    oracle = VPTOracle(tables, camk, OW, OH, seed=0)
    expect = _expect(oracle.vpt, OW, OH, OSPP)
    np.testing.assert_allclose(image, expect, rtol=1e-3, atol=2e-4)
    assert expect.mean() > 1e-3


def _cloud():
    """``test_oracle_volume.py::_scene`` by the port's builder: a 5^3 cloud
    box under one emissive sphere."""
    g = np.random.default_rng(7)
    grid = (g.uniform(0.1, 1.0, (5, 5, 5)) ** 2).astype(np.float32)
    b = SceneBuilder()
    b.set_density_grid(grid, (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    b.add_heterogeneous_medium(0.0, (0.05, 0.08, 0.1), (1.4, 1.2, 1.0))
    b.add_sphere_light((0.0, 1.8, 0.0), 0.9, (12.0, 10.0, 8.0))
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0.3, 3.5, 1)
    return b.build("cpu"), dict(c2w=c2w, fov_deg=55.0)


def _cloud_render(nee):
    tables, camk = _cloud()
    cam = PinholeCamera.make(VW / VH, device="cpu", **camk)
    integ = make_volume_integrator(tables, scene_statics(tables), max_depth=3, nee=nee,
                                   max_steps=64, fused="never")
    return tables, camk, render(tables, cam, integ, VW, VH, VSPP, seed=0).image


def test_het_vpt_matches_oracle():
    """Heterogeneous delta tracking without NEE (the port of
    ``test_oracle_volume.py::test_het_vpt_matches_oracle``)."""
    tables, camk, image = _cloud_render(False)
    oracle = HetVolumeOracle(tables, camk, VW, VH, seed=0)
    expect = _expect(lambda px, py, s: oracle.vpt(px, py, s, 3, 64), VW, VH, VSPP)
    np.testing.assert_allclose(image, expect, rtol=2e-3, atol=3e-4)
    assert expect.mean() > 1e-3


def test_het_vpt_nee_matches_oracle():
    """Heterogeneous tracking with NEE: cone light samples and ratio-tracked
    transmittance (the port of
    ``test_oracle_volume.py::test_het_vpt_nee_matches_oracle``)."""
    tables, camk, image = _cloud_render(True)
    oracle = HetVolumeNEEOracle(tables, camk, VW, VH, seed=0)
    oracle._tables = tables
    expect = _expect(lambda px, py, s: oracle.vpt_nee(px, py, s, 3, 64), VW, VH, VSPP)
    np.testing.assert_allclose(image, expect, rtol=2e-3, atol=3e-4)
    assert (expect.sum(-1) > 0).mean() > 0.3
