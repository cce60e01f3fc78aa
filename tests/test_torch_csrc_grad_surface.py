"""CPU rehearsal of the single-path surface kernels' lane code: K1a
(``mega_path``) and K5 (``mega_grad_path``) on K1c's pass
(``csrc/mega_path.cuh``'s ``pass_rays`` / walk / ``path_end``) with K5's
accumulator ``Grad`` (``csrc/mega_grad.cuh``).

g++ compiles the headers under the shim of ``tests/test_torch_csrc_tracking.py``
(plus ``make_float4`` and a fused ``__fmaf_rn``), without other fused
multiply-adds, beside the host code of ``tests/test_torch_csrc_mega.py``. A
host program runs, per ray of one sample's camera rays,

* the reference: ``bounce`` until the path ends (the nearest walk, then each
  light sample's shadow walk over the blocks copy of the table), with
  ``NoGrad`` (K1a's radiance) or with ``Grad`` summing inline (K5's planes);
* the lane of the kernels (``megakernel.cu``'s ``single_path``) for a
  "warp" of 32 lanes in lockstep: per pass one walk of each lane's path ray
  (K1a on a culled table: and of the shadow ray its last vertex deferred;
  K5 and K1a on a staged table walk every shadow ray at once, and K1a is
  checked both ways on every walk), then ``path_end``, with each walk: every row by the whole pair test with the blocks bits as
  words and the shadow rays walked at once over the same rows (a table
  staged whole in shared memory), every row plane first with the bits as
  bytes, and, on a table the kernels cull (``FusedScene.culls``), the chunk
  table's culled walk;

and holds the lane's radiance and every Jacobian plane bitwise the
reference's, lane by lane, and both against the plain versions
(``mega_path_plain``; ``mega_grad_path_plain``: forward-mode autodiff of the
wavefront integrator) inside ``chip_smoke.py``'s gates (glibc's ``sinf`` /
``cosf`` are not PyTorch's).

Scenes: K5's three cases of ``chip_smoke.py`` (Cornell with its own albedos
and Le x 1.3, M = 3 in a bucket of 4; the 16-light box under power picks,
depth 2, M = 1; four lights facing in under "all" with uniform sampling,
whose vertices defer their fourth light sample and walk three inline) and a
sphere mesh of two groups with two materials (bucket 2), which the kernels
cull.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_csrc_mega import (
    HOST, K1_ATOL, K1_PIXEL_DIFF_SHARE, K1_RTOL, MEAN_BAND_KERNEL_VS_PLAIN, SHIM,
    WALK_BYTES, WALK_CULLED, WALK_WORDS, _cornell, _ptr)
from test_torch_csrc_tracking import CSRC
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.geometry import kernels
from xraytracer_tpu_torch.integrators import megakernel as mk
from xraytracer_tpu_torch.math import from_rows
from xraytracer_tpu_torch.scene.builder import SceneBuilder, scene_statics
from xraytracer_tpu_torch.scene.presets import cornell_camera
from xraytracer_tpu_torch.scene.tables import rejoin_appearance

torch.set_num_threads(1)

W, H = 16, 12
SAMPLE = 1

LANES = r"""
#include "mega_grad.cuh"
""" + HOST + r"""
// one lane's accumulator: NoGrad, or Grad summing into lane i's column of
// the (3 + 9M + 3L, n) output (a lane past n: no planes)
template <class J> struct Acc;
template <> struct Acc<NoGrad> {
  static NoGrad make(const int32_t*, int, int, int, float*, int, int) { return NoGrad(); }
};
template <int MB> struct Acc<Grad<MB>> {
  static Grad<MB> make(const int32_t* om, int no, int nm, int nl, float* out,
                       int n, int i) {
    return i < n ? Grad<MB>(om, no, nm, nl, out, n, i) : Grad<MB>(om, no, 0, 0, out, n, 0);
  }
};

// radiance planes 0-2 of lane i
static void put_l(float* out, int n, int i, float3 L) {
  out[i] = L.x;
  out[(size_t)n + i] = L.y;
  out[2 * (size_t)n + i] = L.z;
}

// the reference: bounce until the path ends, sums inline
template <class J>
static void bounce_lanes(const MegaScene& S, const float* o, const float* d,
                         const int32_t* keys, int n, const int32_t* obj_mat,
                         int n_obj, int n_mats, float* out) {
  const float3 center = ld3(S.center);
  for (int i = 0; i < n; ++i) {
    J jac = Acc<J>::make(obj_mat, n_obj, n_mats, S.n_lights, out, n, i);
    Path p;
    start_path(p, true, (uint32_t)keys[i], load3(o, i), load3(d, i));
    while (p.act && p.it < S.max_depth) bounce(S, center, p, jac);
    put_l(out, n, i, p.L);
  }
}

// the kernels' lane (megakernel.cu's single_path), 32 lanes in lockstep a
// pass at a time; walk 0: every row by the whole pair test, bits as words,
// the shadow rays walked at once over the same rows (a staged table); 1:
// plane first, bits as bytes; 2: the culled walk (1, 2: the shadow rays
// walked at once over the blocks copy). Returns the shadow rays deferred.
template <class J, bool DEFER>
static int path_lanes(int walk, const MegaScene& S, const uint32_t* words,
                      const float* o, const float* d, const int32_t* keys,
                      int n, const int32_t* obj_mat, int n_obj, int n_mats,
                      float* out) {
  const float3 center = ld3(S.center);
  const int T = S.t_total;
  int deferred = 0;
  for (int w0 = 0; w0 < n; w0 += 32) {
    HostWarp w;
    Path p[32];
    Pending pend[32];
    J* jac[32];
    for (int i = 0; i < 32; ++i) {
      const int r = w0 + i;
      const bool live = r < n;
      const float3 z = make_float3(0.f, 0.f, 0.f);
      start_path(p[i], live, live ? (uint32_t)keys[r] : 0u,
                 live ? load3(o, r) : z, live ? load3(d, r) : z);
      pend[i].on = false;
      jac[i] = new J(Acc<J>::make(obj_mat, n_obj, n_mats, S.n_lights, out, n, r));
    }
    for (int pass = 0; pass <= S.max_depth; ++pass) {
      bool any = false;
      for (int i = 0; i < 32; ++i)
        any |= pass_rays(center, p[i], pend[i], w.path[i], w.shadow[i]);
      if (!w.vote(any)) break;
      if (walk == 2) {
        culled_pair_walk(w, S.boxes, PlainRows{S.coef}, ByteBits{S.blocks}, T);
      } else {
        for (int i = 0; i < 32; ++i) {
          SweepRay& a = w.path[i];
          SweepRay& s = w.shadow[i];
          if (walk == 0)
            test_pair_rows<false>(PlainRows{S.coef}, WordBits{words}, 0, T, a,
                                  s, !a.done, !s.done);
          else
            test_pair_rows<true>(PlainRows{S.coef}, ByteBits{S.blocks}, 0, T,
                                 a, s, !a.done, !s.done);
        }
      }
      for (int i = 0; i < 32; ++i) {
        deferred += w.shadow[i].done ? 0 : 1;
        const int row = w.path[i].best_i;
        const bool blocked = w.shadow[i].best_i >= 0;
        if (walk == 0)
          path_end<DEFER>(S, center, p[i], pend[i], *jac[i], row, blocked,
                          PlainRows{S.tri_rec},
                          RowsShadow<PlainRows, WordBits>{PlainRows{S.coef},
                                                          WordBits{words}, T});
        else
          path_end<DEFER>(S, center, p[i], pend[i], *jac[i], row, blocked,
                          PlainRows{S.tri_rec}, GlobalShadow{S});
      }
    }
    for (int i = 0; i < 32; ++i) {
      if (w0 + i < n) put_l(out, n, w0 + i, p[i].L);
      delete jac[i];
    }
  }
  return deferred;
}

template <class F>
static void by_bucket(int n_mats, F f) {
  switch (grad_bucket(n_mats)) {
    case 1: f((Grad<1>*)nullptr); break;
    case 2: f((Grad<2>*)nullptr); break;
    case 4: f((Grad<4>*)nullptr); break;
    default: f((Grad<MAX_GRAD_MATS>*)nullptr); break;
  }
}

extern "C" {
// grad = 0: K1a (3 planes), 1: K5; lane = 0: the reference, 1: the lane
// deferring each vertex's last shadow ray (K1a only), 2: walking every
// shadow ray at once
int rh_single(int grad, int lane, int walk, const float* o, const float* d,
              const int32_t* keys, int n, SCENE_PARAMS, const uint32_t* words,
              const int32_t* obj_mat, int n_obj, int n_mats, float* out) {
  const MegaScene S = scene_from(SCENE_ARGS);
  int deferred = 0;
  if (!grad) {
    if (lane == 1)
      deferred = path_lanes<NoGrad, true>(walk, S, words, o, d, keys, n,
                                          obj_mat, n_obj, n_mats, out);
    else if (lane == 2)
      deferred = path_lanes<NoGrad, false>(walk, S, words, o, d, keys, n,
                                           obj_mat, n_obj, n_mats, out);
    else
      bounce_lanes<NoGrad>(S, o, d, keys, n, obj_mat, n_obj, n_mats, out);
    return deferred;
  }
  by_bucket(n_mats, [&](auto tag) {
    using J = typename std::remove_pointer<decltype(tag)>::type;
    if (lane)
      deferred = path_lanes<J, false>(walk, S, words, o, d, keys, n, obj_mat,
                                      n_obj, n_mats, out);
    else
      bounce_lanes<J>(S, o, d, keys, n, obj_mat, n_obj, n_mats, out);
  });
  return deferred;
}
}
"""

_P = ctypes.c_void_p
_I = ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not found: the CUDA headers cannot be rehearsed on the host")
    tmp = tmp_path_factory.mktemp("grad_surface_rehearsal")
    (tmp / "cuda_runtime.h").write_text(
        SHIM + "#include <type_traits>\n"
               "inline float4 make_float4(float x, float y, float z, float w) "
               "{ return {x, y, z, w}; }\n"
               "#define __host__\n"
               "inline int __ldg(const int* p) { return *p; }\n"
               "inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }\n")
    (tmp / "lanes.cpp").write_text(LANES)
    out = tmp / "libgrad_surface_rehearsal.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{tmp}", f"-I{os.path.abspath(CSRC)}", "-o", str(out),
         str(tmp / "lanes.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(out))
    h.rh_coeffs.argtypes = [_I] + [_P] * 8
    h.rh_coeffs.restype = None
    h.rh_single.argtypes = [_I, _I, _I, _P, _P, _P, _I] + [_P] * 9 + [_P, _P, _I, _I, _P]
    h.rh_single.restype = _I
    return h


# --------------------------------------------------------------------------
# scenes
# --------------------------------------------------------------------------
def _cornell_own():
    tables, camk = _cornell()
    alb = tables.mat_albedo.clone()
    alb[1] = torch.tensor([0.12, 0.75, 0.1])
    alb[2] = torch.tensor([0.8, 0.1, 0.05])
    return tables, camk, alb, 1.3


def _box():
    tables, camk = chip_smoke.light_box_scene("cpu")
    return tables, camk, None, 1.0


def _room4():
    tables = chip_smoke.many_light_scene("cpu", n_side=2, face_in=True)
    return tables, cornell_camera(), None, 1.3


def _sphere2():
    """A lat-long sphere mesh (red) over a floor (white) under a quad light:
    640 rows, two groups of the chunk table, two materials."""
    b = SceneBuilder()
    red = b.add_lambert((0.8, 0.2, 0.1))
    white = b.add_lambert((0.8, 0.8, 0.8))
    b.add_sphere_mesh((0.0, 0.0, 0.0), 1.0, 24, 12, material=red)
    floor = np.asarray([[[-4, -1, -4], [4, -1, -4], [4, -1, 4]],
                        [[-4, -1, -4], [4, -1, 4], [-4, -1, 4]]], np.float32)
    b.add_mesh(floor, material=white)
    b.add_quad_light((-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (-1.0, 3.0, 1.0),
                     (10.0, 10.0, 10.0))
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0.6, 4.0, 1)
    return b.build("cpu"), dict(c2w=c2w, fov_deg=45.0), None, 1.0


SCENES = {
    # name: (scene factory, max_depth, cosine, nee_mode)
    "cornell, Le x 1.3, own albedos": (_cornell_own, 3, True, "all"),
    "16-light box, power": (_box, 2, True, "power"),
    "4 lights facing in, all, uniform": (_room4, 3, False, "all"),
    "sphere, two groups, two materials": (_sphere2, 3, True, "all"),
}


class Case:
    """A scene's gradient scene, one sample's camera rays, the live record
    table and emission, and host copies of what the launchers prepare."""

    def __init__(self, lib, name):
        factory, depth, cosine, nee_mode = SCENES[name]
        tables, camk, albedo, le_scale = factory()
        st = scene_statics(tables)
        f = mk.try_make_fused_grad_path(tables, st, depth, nee=True,
                                        cosine_sampling=cosine, nee_mode=nee_mode,
                                        force=True)
        assert f is not None, name
        self.gs = gs = f.grad_scene
        fs = self.fs = gs.fs
        self.le = tables.al_le * le_scale
        self.rec = rejoin_appearance(tables._replace(
            mat_albedo=tables.mat_albedo if albedo is None else albedo,
            al_le=self.le)).tri_rec.contiguous()
        if fs.n_lights:
            fs.lights[:fs.n_lights, 13:16] = self.le[:fs.n_lights]
        cam = PinholeCamera.make(W / H, device="cpu", **camk)
        view = mk.try_make_fused_spp_render(tables, st, cam, W, H, 0, depth, nee=True,
                                            cosine_sampling=cosine, nee_mode=nee_mode,
                                            force=True).view
        keys, self.o, self.d = mk._camera_rays_plain(view, SAMPLE)
        self.keys = keys
        self.keys32 = mk._i32_bits(keys)
        self.o, self.d = self.o.contiguous(), self.d.contiguous()
        self.n = self.o.shape[0]
        t_total = tables.tri_v0.shape[0]
        center = kernels._center(tables.tri_v0)
        self.center = center
        self.coef = torch.empty((t_total, 16))
        self.coef_blocks = torch.empty((t_total, 16))
        lib.rh_coeffs(t_total, _ptr(tables.tri_v0), _ptr(tables.tri_e1),
                      _ptr(tables.tri_e2), _ptr(fs.valid), _ptr(fs.blocks),
                      _ptr(center), _ptr(self.coef), _ptr(self.coef_blocks))
        self.n_groups = -(-(-(-t_total // kernels.SWEEP_CHUNK)) // kernels.SWEEP_GROUP)
        self.boxes = None
        if fs.culls:
            self.boxes, _ = kernels.chunk_boxes(tables.tri_v0, tables.tri_e1,
                                                tables.tri_e2, fs.valid, center)
        blocks = fs.blocks.numpy().astype(np.uint64)
        pad = np.zeros(-(-t_total // 32) * 32, np.uint64)
        pad[:t_total] = blocks
        self.words = torch.as_tensor(
            (pad.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(axis=1)
            .astype(np.uint32).view(np.int32))
        self.ic = (ctypes.c_int * 7)(t_total, fs.n_lights, fs.max_depth, int(fs.nee),
                                     int(fs.le0), int(fs.cosine),
                                     mk.NEE_KINDS[fs.nee_mode])

    def walks(self):
        return [WALK_WORDS, WALK_BYTES] + ([WALK_CULLED] if self.fs.culls else [])

    def run(self, lib, grad, lane, walk=WALK_WORDS):
        """(planes (3 [+ 9M + 3L], N), shadow rays deferred)."""
        gs, fs = self.gs, self.fs
        planes = gs.n_planes if grad else 3
        out = torch.full((planes, self.n), float("nan"))
        deferred = lib.rh_single(
            grad, lane, walk, _ptr(self.o), _ptr(self.d), _ptr(self.keys32), self.n,
            _ptr(self.coef), _ptr(self.coef_blocks), _ptr(self.rec), _ptr(fs.blocks),
            _ptr(self.boxes), _ptr(self.center), _ptr(fs.lights), _ptr(fs.pick_cdf),
            self.ic, _ptr(self.words), _ptr(gs.obj_mat), gs.obj_mat.shape[0], gs.n_mats,
            _ptr(out))
        return out, deferred


_CASES = {}


def _case(lib, name):
    if name not in _CASES:
        _CASES[name] = Case(lib, name)
    return _CASES[name]


def _differing(got, ref):
    return int((got != ref).any(dim=0).sum())


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SCENES))
def test_k5_lane_bitwise_bounce(lib, name):
    """Every walk of K5's lane gives the radiance and every Jacobian plane
    of ``bounce`` + ``Grad`` bit for bit, lane by lane."""
    case = _case(lib, name)
    ref, _ = case.run(lib, 1, 0)
    assert bool(torch.isfinite(ref).all()) and float(ref[:3].sum()) > 0.0, name
    assert float(ref[3:].abs().sum()) > 0.0, name
    for walk in case.walks():
        got, deferred = case.run(lib, 1, 2, walk)
        assert deferred == 0, (name, walk)
        assert torch.equal(got, ref), (
            f"{name}, walk {walk}: {_differing(got, ref)} of {case.n} lanes differ")


@pytest.mark.parametrize("name", list(SCENES))
def test_k1a_lane_bitwise_bounce(lib, name):
    """Every walk of K1a's lane gives ``bounce``'s radiance bit for bit,
    deferring each vertex's last shadow ray into the next walk (the culled
    walk's form) and walking every shadow ray at once (the staged walk's)."""
    case = _case(lib, name)
    ref, _ = case.run(lib, 0, 0)
    assert float(ref.sum()) > 0.0, name
    for walk in case.walks():
        for lane in (1, 2):
            got, deferred = case.run(lib, 0, lane, walk)
            assert (deferred > 0) == (lane == 1), (name, walk, lane)
            assert torch.equal(got, ref), (
                f"{name}, walk {walk}, lane {lane}: {_differing(got, ref)} of "
                f"{case.n} lanes differ")


@pytest.mark.parametrize("name", list(SCENES))
def test_lanes_within_gates_of_plain(lib, name):
    """The lanes against the plain versions inside chip_smoke.py's gates:
    K5's planes against ``mega_grad_path_plain`` (per lane, GRAD_LANE_*),
    K1a's radiance against ``mega_path_plain`` (the K1 gates)."""
    case = _case(lib, name)
    walk = WALK_CULLED if case.fs.culls else WALK_WORDS
    got, _ = case.run(lib, 1, 2, walk)
    img, galb, gle = mk._split_planes(got, case.gs.n_mats, case.fs.n_lights)
    ref = mk.mega_grad_path_plain(case.gs, case.o, case.d, case.keys, case.rec, case.le)
    for what, a, b in zip(("img", "galb", "gle"), (img, galb, gle), ref):
        chip_smoke.compare_grad_lanes(f"{name}, {what}", a.contiguous(), b)
    rad, _ = case.run(lib, 0, 1 if case.fs.culls else 2, walk)
    sc = case.fs.scene._replace(tri_rec=case.rec, al_le=case.le)
    plain = mk.mega_path_plain(mk._bake(
        sc, case.fs.statics, case.fs.max_depth, True, case.fs.le0, case.fs.cosine,
        nee_mode=case.fs.nee_mode, pick_weights=case.fs.pick_weights),
        case.o, case.d, case.keys)
    diff = (rad.T - plain).abs()
    beyond = (diff > K1_ATOL + K1_RTOL * plain.abs()).any(dim=-1)
    assert int(beyond.sum()) <= max(1, K1_PIXEL_DIFF_SHARE * case.n), name
    assert abs(float(rad.mean()) - float(plain.mean())) <= \
        MEAN_BAND_KERNEL_VS_PLAIN * abs(float(plain.mean())), name


def test_cases_reach_every_branch(lib):
    """The cases put the lane's parts to work: buckets 1, 2 and 4, the
    culled walk on a table of two groups, several lights under "all"
    (inline shadow walks beside the deferred one), power picks."""
    n_mats = {_case(lib, name).gs.n_mats for name in SCENES}
    assert n_mats == {1, 2, 3}  # buckets 1, 2 and 4
    sphere = _case(lib, "sphere, two groups, two materials")
    assert sphere.fs.culls and sphere.n_groups == 2
    assert _case(lib, "4 lights facing in, all, uniform").fs.n_lights == 4
    assert not _case(lib, "cornell, Le x 1.3, own albedos").fs.culls
