"""Port parity, step 3-5: scene tables, builder, presets, conversion and
camera rays of ``xraytracer_tpu_torch`` against the JAX package (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xraytracer_tpu.camera import PinholeCamera as JCamera
from xraytracer_tpu.scene import builder as jbuilder
from xraytracer_tpu.scene import presets as jpresets
from xraytracer_tpu.scene import tables as jtables
from xraytracer_tpu_torch import convert
from xraytracer_tpu_torch.camera import PinholeCamera as TCamera
from xraytracer_tpu_torch.geometry.types import Hit, Rays, miss_hit
from xraytracer_tpu_torch.scene import builder as tbuilder
from xraytracer_tpu_torch.scene import presets as tpresets
from xraytracer_tpu_torch.scene import tables as ttables

torch.set_num_threads(1)

FIELDS = ttables.SceneTables._fields


def _mesh_builder(mod, n_theta=33, n_phi=30):
    """The mesh GI scene of bench_mesh.py at its "2k" size: over 512
    triangles, so the Morton reorder runs."""
    b = mod.SceneBuilder()
    white = b.add_lambert((0.8, 0.8, 0.8))
    b.add_sphere_mesh((0.0, 0.0, 0.0), 1.0, n_theta, n_phi, material=white)
    floor = np.asarray(
        [
            [[-4, -1, -4], [4, -1, -4], [4, -1, 4]],
            [[-4, -1, -4], [4, -1, 4], [-4, -1, 4]],
        ],
        np.float32,
    )
    b.add_mesh(floor, material=white)
    b.add_quad_light(
        (-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (-1.0, 3.0, 1.0),
        (10.0, 10.0, 10.0),
    )
    return b


def _mixed_builder(mod):
    """Every table populated: mirror/glass, sphere, lights of each kind, a
    homogeneous medium."""
    b = mod.SceneBuilder()
    m0 = b.add_lambert((0.2, 0.4, 0.6))
    m1 = b.add_mirror()
    m2 = b.add_glass(1.5)
    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    b.add_mesh(tri, material=m0)
    b.add_mesh(tri + 2.0, material=m1)
    b.add_sphere((0, 0, 3), 0.5, material=m2)
    b.add_triangle_light((0, 5, 0), (1, 5, 0), (0, 5, 1), (3.0, 2.0, 1.0))
    b.add_sphere_light((4, 4, 4), 0.25, (7.0, 7.0, 7.0))
    b.add_point_light((1, 2, 3))
    b.add_distant_light((0, -1, 0.5))
    b.add_homogeneous_medium(0.3, 0.1, (0.2, 0.3, 0.4), (-1, -1, -1), (1, 1, 1))
    return b


@pytest.fixture(scope="module", params=["cornell", "mesh2k", "mixed", "empty"])
def pair(request):
    if request.param == "cornell":
        jb, tb = jpresets.build_cornell_box(), tpresets.build_cornell_box()
    elif request.param == "mesh2k":
        jb, tb = _mesh_builder(jbuilder), _mesh_builder(tbuilder)
    elif request.param == "mixed":
        jb, tb = _mixed_builder(jbuilder), _mixed_builder(tbuilder)
    else:
        jb, tb = jbuilder.SceneBuilder(), tbuilder.SceneBuilder()
    return request.param, jb.build(), tb.build(device="cpu")


@pytest.mark.parametrize("field", FIELDS)
def test_tables_equal_field_for_field(pair, field):
    """Both builders are the same host-side numpy code, so every field is
    exactly equal (ints and floats), Morton order and tri_rec included."""
    _, jt, tt = pair
    j = np.asarray(getattr(jt, field))
    t = getattr(tt, field).numpy()
    assert t.shape == j.shape, field
    assert t.dtype == j.dtype, field
    np.testing.assert_array_equal(t, j, err_msg=field)


def test_fields_and_type_ids_match():
    assert FIELDS == jtables.SceneTables._fields
    for name in ("MAT_LAMBERT", "MAT_MIRROR", "MAT_GLASS", "AL_TRIANGLE",
                 "AL_QUAD", "AL_SPHERE", "DL_POINT", "DL_DISTANT",
                 "MED_HOMOG_MIS", "MED_HOMOG_ACHROMATIC", "MED_HOMOG_NOMIS",
                 "MED_HETEROGENEOUS"):
        assert getattr(ttables, name) == getattr(jtables, name)


def test_padding_and_morton_reorder(pair):
    name, jt, tt = pair
    rows = tt.tri_v0.shape[0]
    assert rows == {"cornell": 40, "mesh2k": 2048, "mixed": 8, "empty": 8}[name]
    if name == "mesh2k":
        # the 33*30*2 sphere triangles were reordered along the Morton curve
        raw = np.asarray(_mesh_builder(tbuilder)._tris[0][0])
        monkey = pytest.MonkeyPatch()
        monkey.setattr(tbuilder, "_morton_order", lambda p: np.arange(len(p)))
        try:
            unsorted = np.asarray(_mesh_builder(tbuilder)._tris[0][0])
        finally:
            monkey.undo()
        assert not np.array_equal(raw, unsorted)
    for n in (1, 7, 8, 9, 128, 129, 512, 513):
        assert tbuilder._tri_pad(n) == jbuilder._tri_pad(n)
    pts = np.random.default_rng(0).random((700, 3))
    np.testing.assert_array_equal(tbuilder._morton_order(pts),
                                  jbuilder._morton_order(pts))


def test_scene_statics_equal(pair):
    _, jt, tt = pair
    assert tbuilder.scene_statics(tt) == jbuilder.scene_statics(jt)
    assert tt.n_area_lights == jt.n_area_lights
    assert tt.n_tris == jt.n_tris


def test_convert_round_trip(pair):
    _, jt, tt = pair
    d = {k: np.asarray(v) for k, v in jt._asdict().items()}
    conv = convert.tables_from_numpy(d, device="cpu")
    back = convert.tables_to_numpy(conv)
    for f in FIELDS:
        assert conv._asdict()[f].dtype == getattr(tt, f).dtype, f
        assert torch.equal(conv._asdict()[f], getattr(tt, f)), f
        np.testing.assert_array_equal(back[f], d[f])
    with pytest.raises(ValueError):
        convert.tables_from_numpy({"tri_v0": d["tri_v0"]}, device="cpu")


def test_rejoin_appearance_matches(pair):
    _, jt, tt = pair
    rng = np.random.default_rng(3)
    alb = rng.random(np.asarray(jt.mat_albedo).shape).astype(np.float32)
    jr = jtables.rejoin_appearance(jt._replace(mat_albedo=jnp.asarray(alb)))
    tr = ttables.rejoin_appearance(tt._replace(mat_albedo=torch.as_tensor(alb)))
    np.testing.assert_array_equal(tr.tri_rec.numpy(), np.asarray(jr.tri_rec))
    # with untouched leaves the join reproduces SceneBuilder's record
    same = ttables.rejoin_appearance(tt)
    assert torch.equal(same.tri_rec, tt.tri_rec)


@pytest.mark.parametrize("w,h,fov", [(32, 24, 60.0), (780, 585, 60.0), (64, 64, 45.0)])
def test_camera_rays_match(w, h, fov):
    kw_j = jpresets.cornell_camera()
    kw_t = tpresets.cornell_camera()
    np.testing.assert_array_equal(kw_t["c2w"], np.asarray(kw_j["c2w"]))
    jc = JCamera.make(w / h, c2w=kw_j["c2w"], fov_deg=fov)
    tc = TCamera.make(w / h, c2w=kw_t["c2w"], fov_deg=fov, device="cpu")
    # tan(fov/2) comes from numpy here and from XLA there: 1 ulp at most
    np.testing.assert_allclose(float(tc.scale), float(jc.scale), rtol=2e-7)
    uv = np.random.default_rng(1).random((5000, 2)).astype(np.float32)
    jr = jc.sample_rays(jnp.asarray(uv))
    tr = tc.sample_rays(torch.as_tensor(uv))
    np.testing.assert_allclose(tr.d.numpy(), np.asarray(jr.d), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tr.o.numpy(), np.asarray(jr.o))
    assert tr.o.is_contiguous() and tr.d.is_contiguous()
    conv = convert.camera_from_numpy(
        np.asarray(jc.c2w), np.asarray(jc.scale), np.asarray(jc.aspect), "cpu")
    np.testing.assert_array_equal(
        conv.sample_rays(torch.as_tensor(uv)).d.numpy(),
        TCamera(tc.c2w, conv.scale, tc.aspect).sample_rays(torch.as_tensor(uv)).d.numpy())


def test_preset_cornellbox_and_records():
    tables, cam_kw, render_kw = tpresets.preset_cornellbox(device="cpu")
    _, jcam_kw, jrender_kw = jpresets.preset_cornellbox()
    assert render_kw == jrender_kw
    assert cam_kw["fov_deg"] == jcam_kw["fov_deg"]
    assert int((tables.tri_obj >= 0).sum()) == 36
    m = miss_hit(5)
    assert isinstance(m, Hit) and not bool(m.hit.any())
    assert float(m.t[0]) == np.finfo(np.float32).max
    r = Rays(o=torch.zeros((2, 3)), d=torch.ones((2, 3)))
    assert r.n == 2
    assert torch.equal(r.at(torch.tensor([1.0, 2.0])),
                       torch.tensor([[1.0] * 3, [2.0] * 3]))
