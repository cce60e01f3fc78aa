"""Port parity: the furnace, direct and Whitted integrators, the delta
lights, the ``example`` preset and the CLI's scene inputs.

The port against the JAX package on the CPU: ``sample_delta_light`` on the
same rows and points, the ``example`` preset's tables bitwise, and renders of
the same tables, cameras and seeds (16x12, 2 spp) at ``test_torch_slice.GATE``
(rtol 1e-5 / atol 1e-6). A Whitted pixel beyond that gate would have to be a
glass lane whose Fresnel pick ``u < F`` went the other way (u within 1e-6 of
F); none is. Then ports of the JAX package's integrator tests
(``tests/test_integrators.py``, ``tests/test_materials_lights.py``) with their
thresholds, and the CLI's new presets, integrators and flags.

Budget: 40 s alone on one thread, most of it compiling the JAX renders.
"""

import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import mesh_log, mirror_glass_scene, write_obj
from test_oracle import _whitted_scene
from test_torch_slice import GATE
from xraytracer_tpu import integrators as jint
from xraytracer_tpu import lights as jlights
from xraytracer_tpu.camera import PinholeCamera as JCamera
from xraytracer_tpu.renderer import render as j_render
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu_torch import cli, lights
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.convert import tables_from_numpy, tables_to_numpy
from xraytracer_tpu_torch.integrators import (
    make_direct_integrator,
    make_furnace_integrator,
    make_normal_integrator,
    make_path_integrator,
    make_whitted_integrator,
)
from xraytracer_tpu_torch.math import from_rows
from xraytracer_tpu_torch.renderer import render
from xraytracer_tpu_torch.scene import presets
from xraytracer_tpu_torch.scene.builder import SceneBuilder, scene_statics

torch.set_num_threads(1)

W, H, SPP = 16, 12, 2


def _jax_numpy(jt):
    return {k: np.asarray(v) for k, v in jt._asdict().items()}


def _assert_tables_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sample_delta_light_matches_jax():
    """Point and distant rows, and a -1 row (Le = 0), on seeded points."""
    rng = np.random.default_rng(3)
    jb = jbuilder.SceneBuilder()
    tb = SceneBuilder()
    for b in (jb, tb):
        b.add_point_light((1.5, 4.0, -2.0), (0.9, 0.8, 0.7), 40.0)
        b.add_distant_light((0.2, -1.0, -0.4), (0.5, 1.0, 1.0), 0.6)
    jt, tt = jb.build(), tb.build("cpu")
    _assert_tables_equal(tables_to_numpy(tt), _jax_numpy(jt))
    pos = rng.uniform(-5.0, 5.0, (64, 3)).astype(np.float32)
    idx = np.resize(np.array([0, 1, -1], np.int32), 64)
    want = jlights.sample_delta_light(jt, idx, pos)
    got = lights.sample_delta_light(tt, torch.from_numpy(idx), torch.from_numpy(pos))
    for name in ("wi", "t_max", "pdf", "le"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-6,
                                   err_msg=name)
    assert (got.le[idx < 0] == 0).all() and (got.le[idx >= 0] > 0).all()
    assert (got.t_max[idx == 1] == torch.finfo(torch.float32).max).all()
    assert (got.pdf[idx == 1] == 1.0).all()


def test_obj_light_matches_jax():
    """``_obj_light``: object id -> area-light row, -1 for none."""
    from xraytracer_tpu.integrators.surface import _obj_light as j_obj_light
    from xraytracer_tpu_torch.integrators.surface import _obj_light

    jt = jpresets.build_cornell_box().build()
    tt = tables_from_numpy(_jax_numpy(jt), device="cpu")
    obj = np.arange(-1, tt.obj_light.shape[0], dtype=np.int32)
    got = _obj_light(tt, torch.from_numpy(obj)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_obj_light(jt, obj)))
    assert (got >= 0).sum() == 1 and got[0] == -1


def test_preset_example_tables_equal_jax():
    tables, camk, rk = presets.preset_example(device="cpu")
    jt, jcamk, jrk = jpresets.preset_example()
    _assert_tables_equal(tables_to_numpy(tables), _jax_numpy(jt))
    np.testing.assert_array_equal(camk["c2w"], jcamk["c2w"])
    assert camk["fov_deg"] == jcamk["fov_deg"] and rk == jrk
    # the distant light's direction, -l2w[2], in float32 as the JAX package
    # takes it
    assert tables.dl_dir.dtype == torch.float32 and int(tables.dl_type[0]) == 1


def _scene(name):
    """(JAX tables, camera kwargs) of one parity scene."""
    if name == "cornell":
        return jpresets.build_cornell_box().build(), jpresets.cornell_camera()
    if name == "example":
        jt, camk, _ = jpresets.preset_example()
        return jt, camk
    return _whitted_scene()  # mirror + glass panes, point + distant light


CASES = {
    "furnace": ("cornell", lambda t, s: jint.make_furnace_integrator(t),
                lambda t, s: make_furnace_integrator(t)),
    "direct": ("cornell", lambda t, s: jint.make_direct_integrator(t, s),
               lambda t, s: make_direct_integrator(t, s)),
    "example_normal": ("example", lambda t, s: jint.make_normal_integrator(t),
                       lambda t, s: make_normal_integrator(t)),
    "whitted_d3": ("example", lambda t, s: jint.make_whitted_integrator(t, s, 3),
                   lambda t, s: make_whitted_integrator(t, s, 3)),
    "mirror_glass_whitted_d3": (
        "mirror_glass", lambda t, s: jint.make_whitted_integrator(t, s, 3),
        lambda t, s: make_whitted_integrator(t, s, 3)),
    "mirror_glass_whitted_d4": (
        "mirror_glass", lambda t, s: jint.make_whitted_integrator(t, s, 4),
        lambda t, s: make_whitted_integrator(t, s, 4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_jax(case):
    scene, j_make, t_make = CASES[case]
    jt, camk = _scene(scene)
    jr = j_render(jt, JCamera.make(W / H, **camk),
                  j_make(jt, jbuilder.scene_statics(jt)), W, H, SPP, seed=0)
    tt = tables_from_numpy(_jax_numpy(jt), device="cpu")
    tr = render(tt, PinholeCamera.make(W / H, device="cpu", **camk),
                t_make(tt, scene_statics(tt)), W, H, SPP, seed=0)
    assert tr.n_rejected == jr.n_rejected == 0
    np.testing.assert_allclose(tr.image, jr.image, **GATE)
    assert tr.image.mean() > 0.01


def _cornell(w, h, fov=None):
    tables = presets.build_cornell_box().build("cpu")
    camk = presets.cornell_camera()
    if fov is not None:
        camk = dict(camk, fov_deg=fov)
    return tables, scene_statics(tables), PinholeCamera.make(w / h, device="cpu", **camk)


def test_gi_depth1_equals_direct_on_hits():
    """The port of ``test_integrators.py::test_gi_depth1_equals_direct_on_hits``:
    GI at depth 1 = emitter Le + one NEE bounce = the direct integrator on
    every pixel that hits geometry (FOV 40 so that every primary ray hits)."""
    tables, statics, cam = _cornell(40, 30, fov=40.0)
    r_gi = render(tables, cam, make_path_integrator(tables, statics, max_depth=1,
                                                    nee=True), 40, 30, 4, seed=5)
    r_di = render(tables, cam, make_direct_integrator(tables, statics), 40, 30, 4,
                  seed=5)
    np.testing.assert_allclose(r_gi.image, r_di.image, atol=1e-5)


def _mirror_glass_scene():
    """The floor + mirror sphere + glass sphere of ``tests/test_integrators.py``
    (``chip_smoke.mirror_glass_scene``), square frame."""
    tables, camk = mirror_glass_scene("cpu")
    return tables, PinholeCamera.make(1.0, device="cpu", **camk)


def test_whitted_mirror_glass_live():
    """The port of ``test_integrators.py::test_whitted_mirror_glass_live``."""
    tables, cam = _mirror_glass_scene()
    r = render(tables, cam, make_whitted_integrator(tables, scene_statics(tables), 4),
               48, 48, 8)
    assert r.n_rejected == 0
    assert np.isfinite(r.image).all()
    assert r.image.std() > 0.05


def test_whitted_split_variance():
    """The port of ``test_integrators.py::test_whitted_split_variance``: the
    per-pixel spread across 6 seeds at 16 spp under the same ceilings (mean
    relative std < 0.08 over the frame, < 0.33 over the glass sphere)."""
    tables, cam = _mirror_glass_scene()
    integ = make_whitted_integrator(tables, scene_statics(tables), 4)
    imgs = np.stack([render(tables, cam, integ, 48, 48, 16, seed=s).image
                     for s in range(6)])
    std = imgs.std(axis=0).mean(axis=-1)
    mean = np.maximum(imgs.mean(axis=(0, 3)), 1e-3)
    rel = std / mean
    glass = rel[16:36, 28:46]
    assert rel.mean() < 0.08, rel.mean()
    assert glass.mean() < 0.33, glass.mean()


@pytest.mark.parametrize("cosine", [False, True])
def test_furnace(cosine):
    """The port of ``test_materials_lights.py::test_furnace``: E[fr cos / pdf]
    equals the albedo for both Lambert sampling strategies."""
    albedo = (0.7, 0.5, 0.3)
    b = SceneBuilder()
    quad = np.asarray(
        [
            [[-10, 0, -10], [10, 0, -10], [-10, 0, 10]],
            [[10, 0, -10], [10, 0, 10], [-10, 0, 10]],
        ],
        np.float32,
    )
    b.add_mesh(quad, material=b.add_lambert(albedo))
    tables = b.build("cpu")
    c2w = from_rows(1.0, 0, 0, 0, 0, 0, 1, 0, 0, 1.0, 0, 0, 0, 5.0, 0, 1)
    cam = PinholeCamera.make(1.0, c2w=c2w, fov_deg=30.0, device="cpu")
    r = render(tables, cam, make_furnace_integrator(tables, cosine_sampling=cosine),
               16, 16, 512)
    est = r.image.reshape(-1, 3).mean(axis=0)
    np.testing.assert_allclose(est, albedo, rtol=0.05)


@pytest.mark.parametrize("extra", [
    ["--preset", "whitted"], ["--preset", "example"],
    ["--integrator", "direct"], ["--integrator", "furnace"]])
def test_cli_new_presets_and_integrators(tmp_path, extra):
    out = str(tmp_path / "o.png")
    assert cli.main(["--preset", "cornellbox", "--device", "cpu", "--width", "8",
                     "--height", "6", "--spp", "1", "-o", out] + extra) == 0
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_cli_obj(tmp_path):
    """--obj on the Cornell box written as .obj + .mtl: the port's tables equal
    the JAX CLI's from the same file, and the triangle rows those of the box
    built directly."""
    from xraytracer_tpu import cli as jcli
    from xraytracer_tpu.config import get_preset as j_get_preset
    from xraytracer_tpu_torch.config import get_preset

    log = presets.build_cornell_box(mesh_log())
    path = str(tmp_path / "cornell.obj")
    write_obj(path, log.meshes)
    tables, camk = cli.build_scene(get_preset("cornellbox", obj=path), device="cpu")
    jt, jcamk = jcli.build_scene(j_get_preset("cornellbox", obj=path))
    _assert_tables_equal(tables_to_numpy(tables), _jax_numpy(jt))
    direct = log.build("cpu")
    for k in ("tri_v0", "tri_e1", "tri_e2"):
        assert torch.equal(getattr(tables, k), getattr(direct, k)), k
    np.testing.assert_array_equal(camk["c2w"], jcamk["c2w"])
    out = str(tmp_path / "o.ppm")
    assert cli.main(["--obj", path, "--integrator", "normal", "--device", "cpu",
                     "--width", "8", "--height", "6", "--spp", "1", "-o", out]) == 0


def test_cli_density_grid(tmp_path):
    """--density-grid: the grid replaces the procedural cloud, with the JAX
    CLI's camera and the nee preset's medium and light."""
    from xraytracer_tpu import cli as jcli
    from xraytracer_tpu.config import get_preset as j_get_preset
    from xraytracer_tpu_torch.config import get_preset

    grid = os.path.join(os.path.dirname(__file__), "data", "cloud_32.npz")
    tables, camk = cli.build_scene(get_preset("nee"), device="cpu",
                                   density_grid=grid)
    jt, jcamk = jcli.build_scene(j_get_preset("nee"), density_grid=grid)
    _assert_tables_equal(tables_to_numpy(tables), _jax_numpy(jt))
    np.testing.assert_array_equal(camk["c2w"], jcamk["c2w"])
    out = str(tmp_path / "o.png")
    assert cli.main(["--preset", "nee", "--density-grid", grid, "--device", "cpu",
                     "--width", "8", "--height", "6", "--spp", "1", "-o", out]) == 0


def test_cli_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(["--preset", "cornellbox", "--device", "cpu", "--width", "8",
                     "--height", "6", "--spp", "1", "--profile", str(prof),
                     "-o", str(tmp_path / "o.png")]) == 0
    with open(prof / "render.trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
